"""The comparison that decides ``correct``, and the stored-value counts the
yardstick reads, both from the reference's own pruning of the raw weights.

After the window (and after the program's state is freed) a sample of the
requests the window finished is drawn from the seed, with the longest among
them.  The reference (the ``Reference`` of the configuration's architecture
module) runs once over each prompt with the tokens the engine served, and reads, at the position of every served token, the gap by which
that token's logit lies below the reference's best logit there: 0 where
the engine chose the reference's argmax, small where two logits were
within a rounding of each other, large where a token was wrong.  The run is
correct when the widest gap stays within the cell's limit (``limits/``).

The control (``control=True``) is the same reference computed with each
projection in fp8 (e4m3, scaled a row of x and a column of w), the next
precision below the configuration's bf16: at the same positions it reads
the gap of the token that fp8 puts first, and that reading is judged by the
cell's limits as the program's is (``control.py``); it has to come out as
not correct.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.harness.weights import stream_seed
from perfbench.reference import decoder


def sample(tracks: list, t_end: float, k: int, seed: int) -> list:
    """Up to ``k`` requests finished by ``t_end``: the longest (prompt and
    output), and the rest drawn from the seed."""
    done = sorted((tr for tr in tracks if tr.done and tr.times[-1] <= t_end),
                  key=lambda tr: tr.req.idx)
    if not done:
        return []
    longest = max(done, key=lambda tr: (tr.req.prompt_len + tr.req.max_new, -tr.req.idx))
    rest = [tr for tr in done if tr is not longest]
    rng = np.random.default_rng(stream_seed(seed, 12))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with both operands rounded to e4m3 (x scaled a row, w a
    column), summed in float32: an fp8 GEMM."""
    fmax = torch.finfo(torch.float8_e4m3fn).max
    xs = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / fmax
    ws = w.abs().amax(0, keepdim=True).clamp_min(1e-30) / fmax
    xq = (x / xs).to(torch.float8_e4m3fn).float() * xs
    wq = (w / ws).to(torch.float8_e4m3fn).float() * ws
    return xq @ wq


def _gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    best = ref.max(dim=-1).values
    return best - ref.gather(-1, chosen[:, None])[:, 0]


def _reading(picked: list, gaps: torch.Tensor | None) -> dict:
    return {"requests": len(picked), "tokens": int(sum(len(tr.toks) for tr in picked)),
            "max_logit_gap": float(gaps.max()) if gaps is not None else None,
            "argmax_agree": (float(np.mean([bool(g == 0) for g in gaps.tolist()]))
                             if gaps is not None else None)}


def judge(arch, cfg: dict, seed: int, picked: list, device, control: bool = False) -> dict:
    """The widest gap of the served tokens of ``picked``, with the stored
    counts the yardstick reads.  With ``control``, ``"control"`` holds the
    same reading of the tokens fp8 puts first at the same positions, to be
    judged by the same limits."""
    decoder.strict_float32()
    ref_w = arch.Reference(cfg, seed, device)
    seqs = [torch.as_tensor(np.concatenate([tr.prompt, tr.toks[:-1]]), device=device)
            for tr in picked]
    rows = [torch.arange(tr.req.prompt_len - 1, tr.req.prompt_len - 1 + len(tr.toks),
                         device=device) for tr in picked]
    with torch.no_grad():
        ref = ref_w.logits(seqs, rows)
        served = [torch.as_tensor(tr.toks, device=device) for tr in picked]
        gaps = torch.cat([_gaps(r, s) for r, s in zip(ref, served)]) if picked else None
        out = _reading(picked, gaps)
        if control:
            ctl = ref_w.logits(seqs, rows, mm=fp8_matmul) if picked else []
            cgaps = (torch.cat([_gaps(r, c.argmax(-1)) for r, c in zip(ref, ctl)])
                     if picked else None)
            out["control"] = _reading(picked, cgaps)
    out["model"] = ref_w.model()
    out["matrices"] = ref_w.matrices()
    return out
