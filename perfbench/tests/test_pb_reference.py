"""The plain reference against the port at a reduced size, the control that
has to fail the comparison, and the planted faults that have to fail it."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench.harness import runner, spec
from perfbench.reference import prune

SECONDS = 4.0           # a loaded host still finishes a few requests in it
# the limit at this size, set as the cells' are: between the program's
# readings here (0 to 0.02 on these seeds) and the control's (0.16 to 0.40)
TEST_LIMITS = {"max_logit_gap": {"limit": 0.05}, "min_tokens": 20}


def _measure(cfg, mix, cell, seed, device=torch.device("cpu"), **kw):
    return runner.measure(spec.benchmark(), cell, seed, SECONDS, False, device,
                          time.perf_counter(), cfg=cfg, mix=mix, **kw)


@pytest.mark.parametrize("mode", ["tiled_csc", "block_csr"])
def test_reference_prunes_as_the_program_packs(mode, tiny_cfg, tiny_block_cfg):
    """The reference's own rule keeps exactly the values the program's
    packed weight holds."""
    from repro_torch.core.sod import SoDConfig, pack_param

    sod = (tiny_cfg if mode == "tiled_csc" else tiny_block_cfg)["sod"]
    cfg = SoDConfig(mode=sod["mode"], density=sod["density"], prune_method=sod["prune_method"],
                    tile=tuple(sod["tile"]), br=sod["br"], min_dim=sod["min_dim"])
    g = torch.Generator().manual_seed(3)
    for k, n in ((256, 512), (512, 256), (256, 8192)):
        w = (torch.randn(k, n, generator=g) * k ** -0.5).to(torch.bfloat16)
        packed = pack_param(w, cfg).to_dense()[:k, :n]
        assert torch.equal(packed, prune.prune(w, sod)), (k, n)


@pytest.mark.parametrize("which", ["tiled_csc", "block_csr"])
def test_port_against_reference_and_control(which, tiny_cfg, tiny_block_cfg, closed_mix):
    """The port's served tokens pass the limit at this size; the reference
    in fp8 (the control), judged by the same limits through the same
    ``result``, comes out as not correct, reading at least three times the
    program."""
    cfg, cell = ((tiny_cfg, "internlm2_decode128") if which == "tiled_csc"
                 else (tiny_block_cfg, "yi34b_decode128"))
    closed_mix["check"]["requests"] = 1000     # every finished request, as many tokens as a run
    rec = _measure(cfg, closed_mix, cell, 2**31 + 101, control=True)
    bench = spec.benchmark()
    res = runner.result(bench, rec, False, TEST_LIMITS)
    j, c = rec["judged"], rec["judged"]["control"]
    assert j["requests"] >= 3 and j["tokens"] >= 20
    assert res["correct"], j
    ctl = runner.result(bench, rec, False, TEST_LIMITS, judged=c)
    assert not ctl["correct"], c
    assert ctl["checks"]["max_logit_gap"]["value"] == c["max_logit_gap"]
    assert c["tokens"] == j["tokens"] and c["max_logit_gap"] >= 3 * j["max_logit_gap"], (j, c)


@pytest.mark.parametrize("key,value", [("tie_word_embeddings", True), ("attention_bias", True),
                                       ("hidden_act", "gelu"),
                                       ("rope_scaling", {"type": "linear", "factor": 2.0})])
def test_a_configuration_the_decoder_does_not_compute_is_refused(key, value, tiny_cfg):
    """A tied head, a bias, another activation or rope scaling would be
    served and checked as something else: the architecture module refuses
    the configuration."""
    arch = spec.architecture(tiny_cfg)
    arch.port_config(tiny_cfg)
    with pytest.raises(ValueError, match=key):
        arch.port_config({**tiny_cfg, key: value})
    with pytest.raises(ValueError, match=key):
        arch.Reference({**tiny_cfg, key: value}, 1, torch.device("cpu"))


def test_each_configuration_finds_its_architecture(tiny_cfg):
    bench = spec.benchmark()
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        arch = spec.architecture(cfg)
        assert {"port_config", "draw_params", "Reference"} <= set(vars(arch))
        assert arch.port_config(cfg).n_layers == cfg["num_hidden_layers"]
    with pytest.raises(FileNotFoundError):
        spec.architecture({**tiny_cfg, "architectures": ["NoSuchForCausalLM"]})


@pytest.mark.parametrize("fault", ["state", "half", "token"])
def test_a_broken_timed_path_is_not_correct(fault, tiny_cfg, closed_mix):
    """A decode step that keeps its cache unchanged, half the batch given
    the other half's tokens, a token altered where it is produced: each
    comes out as not correct, under the limit at this size and under the
    cell's."""
    # every finished request compared: with 4 slots, 3 sampled ones can all
    # sit in the half a fault spares (at 128 slots, 12 sampled cannot)
    closed_mix["check"]["requests"] = 1000
    rec = _measure(tiny_cfg, closed_mix, "internlm2_decode128", 2**31 + 202, faults=(fault,))
    for limits in (TEST_LIMITS, spec.limits("internlm2_decode128")):
        res = runner.result(spec.benchmark(), rec, False, limits)
        assert not res["correct"], rec["judged"]
        assert rec["judged"]["max_logit_gap"] > 3 * limits["max_logit_gap"]["limit"]


@pytest.mark.cuda
def test_port_against_reference_on_the_card(cuda_device, tiny_cfg, closed_mix):
    """The same comparison through the CUDA kernels."""
    rec = _measure(tiny_cfg, closed_mix, "internlm2_decode128", 2**31 + 303, cuda_device,
                   control=True)
    res = runner.result(spec.benchmark(), rec, False, TEST_LIMITS)
    assert res["correct"], rec["judged"]
    assert res["device"]["platform"] == "gpu"
