"""pixtral-12b and musicgen-medium as whole models: the port against the JAX
package.

The reduced configs in float32, packed ``tiled_csc`` at density 0.3 by each
package (byte-equal packs: ``tests/test_torch_frontends.py``), weights from
the JAX model through ``params_from_numpy`` and the reference's batches.
Static serving follows the reference's ``launch.serve``, whose VLM decode
starts at the text's length (fault R5, kept; ``ROADMAP.md`` §C).

Tolerances: logits atol 1e-4 / rtol 1e-4, losses rtol 1e-5, gradients atol
1e-6 / rtol 1e-4; greedy tokens and ``launch.serve``'s ``sample`` exactly.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import sod as jsod
from repro.data.pipeline import SyntheticLMData as JData
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import model as jmodel_mod
from repro_torch import configs
from repro_torch.core import sod
from repro_torch.core.tree import leaves_with_path
from repro_torch.data.pipeline import to_device
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import autotune
from repro_torch.launch import serve, steps, train
from repro_torch.models.model import LM
from repro_torch.serving import Engine

B, S, GEN = 2, 32, 4            # pixtral's S counts its 16 patches
ATOL = RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
ARCHS = ("pixtral-12b", "musicgen-medium")
SOD = dict(mode="tiled_csc", density=0.3, min_dim=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' CPU ops gain nothing from intra-op threads, and
    under the suite's parallel workers every worker's threads contend for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "jax_tuning_cache.json"))
    autotune.set_cache(None)
    yield
    autotune.set_cache(None)


def _configs(arch: str, packed: bool = True):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).with_(dtype="float32")
    tcfg = configs.reduced(configs.get_config(arch)).with_(dtype="float32")
    if packed:
        jcfg, tcfg = jcfg.with_(sod=jsod.SoDConfig(**SOD)), tcfg.with_(sod=sod.SoDConfig(**SOD))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _reference_init(arch: str):
    jcfg, _ = _configs(arch, packed=False)
    return jax.tree_util.tree_map(
        np.asarray, jmodel_mod.build_model(jcfg).init(jax.random.PRNGKey(0)))


def _both(arch: str):
    """(reference config, port config, reference params, port params), each
    package's packs of the same float32 weights."""
    jcfg, tcfg = _configs(arch)
    np_params = _reference_init(arch)
    jp = jsod.sodify_params(jax.tree_util.tree_map(jnp.asarray, np_params), jcfg.sod)
    tp = sod.sodify_params(params_from_numpy(np_params, tcfg, device="cpu"), tcfg.sod)
    return jcfg, tcfg, jp, tp


def _batch(arch: str, seq: int = S) -> dict:
    return {k: np.asarray(v)
            for k, v in JData(_configs(arch)[0], B, seq, seed=0).batch(0).items()}


_TOKEN = re.compile(r"\['([^']+)'\]|\[(\d+)\]|\.(\w+)")


def _ref_at(tree, path: str):
    """The reference's value at a port leaf path (``['layers'][l]`` is the
    reference's ``blocks`` at (l, 0))."""
    index = []
    for key, i, attr in _TOKEN.findall(path):
        if i:
            index.append(int(i))
        elif key:
            tree = tree["blocks" if key == "layers" else key]
        else:
            tree = getattr(tree, attr)
    return np.asarray(tree)[(index[0], 0) if index else ()]


def _step_tokens(nxt, cfg):
    return nxt.reshape(B, 1, cfg.n_codebooks) if cfg.family == "audio" else nxt.reshape(B, 1)


def _serve_both(arch: str) -> dict:
    """Both packages' full forward, prefill and GEN greedy decode steps, the
    way static serving runs them: prefill_cache, then decode from its
    position."""
    jcfg, tcfg, jp, tp = _both(arch)
    prompt = {k: v for k, v in _batch(arch).items() if k != "targets"}
    jprompt = {k: jnp.asarray(v) for k, v in prompt.items()}
    jmodel = jmodel_mod.build_model(jcfg)
    jout = {"apply": np.asarray(jmodel.apply(jp, jprompt)[0])}
    last, cache, pos0 = jserve.prefill_cache(jmodel, jp, jprompt, S + GEN)
    jout.update(prefill=np.asarray(last), pos0=pos0, logits=[], tokens=[])
    decode = jax.jit(jsteps.make_decode_step(jmodel))
    tok = _step_tokens(jnp.argmax(last, axis=-1), jcfg)
    for t in range(GEN):
        nxt, logits, cache = decode(jp, cache, tok, jnp.asarray(pos0 + t, jnp.int32))
        tok = _step_tokens(nxt, jcfg)
        jout["logits"].append(np.asarray(logits))
        jout["tokens"].append(np.asarray(nxt))

    model = LM(tcfg)
    tprompt = to_device(prompt, "cpu")
    patches = tprompt.get("patch_embeds")
    with torch.inference_mode():
        tout = {"apply": model.apply(tp, tprompt["tokens"], patch_embeds=patches)[0].numpy()}
        last, cache, pos0 = serve.prefill_cache(model, tp, tprompt["tokens"], S + GEN,
                                                patch_embeds=patches)
        tout.update(prefill=last.numpy(), pos0=pos0, logits=[], tokens=[])
        decode = steps.make_decode_step(model)
        tok = serve.step_tokens(last.argmax(dim=-1), B, tcfg)
        for t in range(GEN):
            nxt, logits, cache = decode(tp, cache, tok, pos0 + t)
            tok = serve.step_tokens(nxt, B, tcfg)
            tout["logits"].append(logits.numpy())
            tout["tokens"].append(nxt.numpy())
    return {"jax": jout, "torch": tout}


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    return _serve_both(request.param)


def test_apply_logits_match(runs):
    """The full forward: pixtral's logits over patches and text, musicgen's
    (B, S, 4, V)."""
    t, j = runs["torch"]["apply"], runs["jax"]["apply"]
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)


def test_prefill_and_decode_logits_match(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["pos0"] == j["pos0"]
    np.testing.assert_allclose(t["prefill"], j["prefill"], atol=ATOL, rtol=RTOL)
    for lt, lj in zip(t["logits"], j["logits"], strict=True):
        np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=RTOL)
    assert np.isfinite(t["prefill"]).all()


def test_greedy_tokens_equal(runs):
    """Every step's greedy ids, (B, 1) or musicgen's (B, 1, 4)."""
    np.testing.assert_array_equal(np.stack(runs["torch"]["tokens"]),
                                  np.stack(runs["jax"]["tokens"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch):
    """As ``tests/test_serving.py``'s check, for pixtral too: the prompt
    without its last token prefilled, the cache grown by one, and that
    token decoded at ``s - 1`` (pixtral: ``s - 1 + n_patches``, the
    position the cache gives it) equals the full forward's last logits."""
    _, tcfg, _, tp = _both(arch)
    model = LM(tcfg)
    batch = to_device(_batch(arch), "cpu")
    patches = batch.get("patch_embeds")
    with torch.inference_mode():
        full = model.apply(tp, batch["tokens"], patch_embeds=patches)[0][:, -1]
        _, cache = model.prefill(tp, batch["tokens"][:, :-1], patch_embeds=patches)
        s = batch["tokens"].shape[1] + (tcfg.n_patches if patches is not None else 0)
        cache = model.grow_cache(cache, s)
        step, _ = model.decode_step(tp, cache, batch["tokens"][:, -1:], s - 1)
    assert tuple(step.shape[2:]) == tuple(full.shape[1:])
    np.testing.assert_allclose(step[:, 0].numpy(), full.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match(arch):
    """``LM.loss`` (pixtral's over the text only, musicgen's over every
    codebook) and every gradient, ``patch_proj``'s, the audio ``embed``
    stack's and the packed head's included."""
    jcfg, tcfg, jp, tp = _both(arch)
    batch = _batch(arch)
    jloss, jmet, jg = jax.jit(jsteps.make_loss_and_grads(
        jmodel_mod.build_model(jcfg)))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tmet, tg = steps.make_loss_and_grads(LM(tcfg))(tp, to_device(batch, "cpu"))
    for key in ("loss", "ce"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=LOSS_RTOL,
                                   err_msg=key)
    jg = jax.tree_util.tree_map(
        lambda g: None if g.dtype == jax.dtypes.float0 else np.asarray(g), jg)
    checked = set()
    for path, leaf in leaves_with_path(tg):
        np.testing.assert_allclose(leaf.float().numpy(), _ref_at(jg, path), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=path)
        checked.add(path.split("]")[0] + "]")
    want = {"['embed']", "['head']", "['layers']"} | (
        {"['patch_proj']"} if arch == "pixtral-12b" else set())
    assert want <= checked
    key = "patch_proj" if arch == "pixtral-12b" else "embed"
    assert float(tg[key].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_sample_equals_the_reference(arch, monkeypatch):
    """Both packages' static ``launch.serve`` at ``--sod tiled_csc`` on the
    same float32 weights and prompt give the same ``sample``; musicgen's is
    codebook 0 of row 0 a step, and its generated ids are (B, gen, 4)."""
    prompt_len = 24 if arch == "pixtral-12b" else 16
    argv = ["--arch", arch, "--reduced", "--batch", str(B), "--prompt-len",
            str(prompt_len), "--gen", "3", "--sod", "tiled_csc", "--density", "0.3"]
    reduced = jconfigs.reduced
    monkeypatch.setattr(jconfigs, "reduced", lambda c: reduced(c).with_(dtype="float32"))
    want = jserve.main(argv)
    jcfg, tcfg = _configs(arch)
    np_params = jax.tree_util.tree_map(
        np.asarray, jmodel_mod.build_model(jcfg).init(jax.random.PRNGKey(0)))
    tp = sod.sodify_params(params_from_numpy(np_params, tcfg, device="cpu"), tcfg.sod)
    prompt = to_device(JData(jcfg, B, prompt_len, seed=0).batch(0), "cpu")
    prepared = serve.Prepared(LM(tcfg), tp, prompt["tokens"],
                              patch_embeds=prompt.get("patch_embeds"))
    got = serve.main(argv + ["--device", "cpu"], prepared=prepared)
    assert got["sample"] == want["sample"] and got["logits_finite"]
    ids = np.asarray(got["generated_ids"])
    assert ids.shape == ((B, 3, 4) if arch == "musicgen-medium" else (B, 3))
    if arch == "musicgen-medium":
        assert got["sample"] == [int(i) for i in ids[0, :, 0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_entry_points_on_the_cpu(arch, tmp_path):
    """``launch.serve`` and one ``launch.train`` step at the reduced size
    with the port's own weights; a VLM prompt of the patches alone (no
    text) serves, as the reference's does."""
    prompt_len = "24" if arch == "pixtral-12b" else "8"
    base = ["--arch", arch, "--reduced", "--sod", "tiled_csc", "--device", "cpu",
            "--batch", "2", "--prompt-len", prompt_len, "--gen", "2"]
    static = serve.main(base)
    assert static["logits_finite"] and static["kernel_launches"] == {
        "sod_matmul": 0, "block_matmul": 0}
    assert static["kernel_dispatch"] == {"torch_oracle[prior]": (2 * 7 + 1) * 3}
    if arch == "pixtral-12b":
        patches_only = serve.main(base[:-4] + ["--prompt-len", "16", "--gen", "2"])
        assert patches_only["logits_finite"]
        assert np.asarray(patches_only["generated_ids"]).shape == (2, 2)
    out = train.main(["--arch", arch, "--reduced", "--sod", "tiled_csc", "--device", "cpu",
                      "--steps", "1", "--batch", "2", "--seq", "32", "--ckpt-dir",
                      str(tmp_path / "ck"), "--log-every", "1000"])
    assert len(out["losses"]) == 1 and all(np.isfinite(out["losses"] + out["grad_norms"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_the_frontends(arch):
    """The engine serves token-in/token-out families only, with the
    reference's error, in both packages; so does ``serve --engine``."""
    _, tcfg = _configs(arch, packed=False)
    model = LM(tcfg)
    msg = "engine serves token-in/token-out families"
    with pytest.raises(NotImplementedError, match=msg):
        Engine(model, {}, max_len=16)
    with pytest.raises(NotImplementedError, match=msg):
        from repro.serving import Engine as JEngine
        JEngine(jmodel_mod.build_model(_configs(arch, packed=False)[0]), {}, max_len=16)
    with pytest.raises(NotImplementedError, match=msg):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--engine",
                    "--requests", "2", "--prompt-len", "24", "--gen", "2"])
