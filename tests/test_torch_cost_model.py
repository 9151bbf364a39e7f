"""The port's paper-claims layer against the JAX package.

``repro_torch.core.topology`` and ``repro_torch.core.cost_model`` are copies
of the reference's framework-free modules (the port's card, ``H100_SXM``,
in place of the TPU): every report of every accelerator model must equal
the reference's with ``==`` (the same float operations in the same order),
and the paper's claim table (``benchmarks/paper_figs.py`` and
``paper_real_models.py``, read and not edited) must pass with the port's
``cost_model``, ``Workload`` and ``PAPER_PROFILES`` patched in.  The
card's rates have one source: the autotuner's prior, ``chip_smoke.py`` and
``scripts/sod_matmul_probe.py`` read ``H100_SXM``.
"""
import dataclasses
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core import pruning as jpruning
from repro.core import topology as jtopology
from repro_torch.core import cost_model as cm
from repro_torch.core import pruning, topology
from repro_torch.kernels import autotune

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODELS = ("dense_baseline", "sparse_on_dense", "ese", "scnn", "snap", "sigma")
# the workloads of tests/test_cost_model.py and of the paper's figures
CASES = [(512, 1024, 1024, 1.0, 1.0), (512, 1024, 1024, 0.2, 1.0),
         (512, 2048, 2048, 0.05, 1.0), (512, 2048, 2048, 0.9, 1.0),
         (1024, 1024, 1024, 0.3, 0.3), (3025, 363, 96, 0.84, 1.0),
         (1, 128, 128, 0.6, 1.0), (1, 128, 128, 0.7, 1.0),
         (4096, 4096, 4096, 1.0, 1.0), (64, 2048, 2048, 0.1, 1.0),
         (512, 4096, 4096, 0.41, 0.69)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Nothing here gains from intra-op threads; the suite's parallel
    workers would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(n: int = 120, seed: int = 0) -> list[tuple]:
    """Seeded workloads: M, K, N log-uniform over 1..4096, densities
    0.01..1.0 (a quarter of each side exactly 1.0), plus CASES."""
    rng = np.random.default_rng(seed)
    dims = np.exp(rng.uniform(0, np.log(4096), (n, 3))).round().astype(int)
    dens = rng.uniform(0.01, 1.0, (n, 2))
    dens[rng.uniform(size=(n, 2)) < 0.25] = 1.0
    return CASES + [(*map(int, d), *map(float, p)) for d, p in zip(dims, dens)]


def _report(r) -> tuple:
    """Every field and derived metric of a Report."""
    return (dataclasses.astuple(r), r.time_s, r.eff_tops, r.tops_per_mm2(),
            r.tops_per_mm2(include_sram=True), r.tops_per_watt)


def test_topology_fields_match_the_reference():
    names = [f.name for f in dataclasses.fields(topology.ChipSpec)]
    assert names == [f.name for f in dataclasses.fields(jtopology.ChipSpec)]
    assert [f.name for f in dataclasses.fields(topology.PaperTech)] == [
        f.name for f in dataclasses.fields(jtopology.PaperTech)]
    assert dataclasses.asdict(topology.PAPER_28NM) == dataclasses.asdict(
        jtopology.PAPER_28NM)
    for mesh in ("SINGLE_POD", "MULTI_POD"):
        ours, ref = getattr(topology, mesh), getattr(jtopology, mesh)
        assert (ours.axes, ours.shape, ours.num_chips) == (ref.axes, ref.shape,
                                                           ref.num_chips)
        assert [ours.axis_size(a) for a in ours.axes] == [ref.axis_size(a)
                                                          for a in ref.axes]
        assert ours.chip is topology.H100_SXM
    assert not hasattr(topology, "TPU_V5E")


def test_h100_spec_is_the_data_sheet():
    h = topology.H100_SXM
    assert (h.peak_bf16_flops, h.hbm_bandwidth, h.hbm_bytes) == (989e12, 3.35e12,
                                                                 80 * 10**9)
    assert (h.vmem_bytes, h.ici_links, h.ici_link_bandwidth) == (228 * 1024, 18, 25e9)
    assert h.flops_per_byte_balance == 989e12 / 3.35e12


@pytest.mark.parametrize("model", MODELS)
def test_reports_equal_the_reference(model):
    ours, ref = getattr(cm, model), getattr(jcm, model)
    for m, k, n, dw, di in _grid():
        w, jw = cm.Workload(m, k, n, dw, di), jcm.Workload(m, k, n, dw, di)
        assert _report(ours(w)) == _report(ref(jw)), (model, m, k, n, dw, di)


@pytest.mark.parametrize("stride,kernel_size", [(1, 1), (4, 11), (2, 3)])
def test_scnn_stride_and_kernel_equal_the_reference(stride, kernel_size):
    for m, k, n, dw, di in _grid(40, seed=1):
        got = cm.scnn(cm.Workload(m, k, n, dw, di), stride=stride,
                      kernel_size=kernel_size)
        want = jcm.scnn(jcm.Workload(m, k, n, dw, di), stride=stride,
                        kernel_size=kernel_size)
        assert _report(got) == _report(want)


def test_breakdown_constants_and_accelerators_equal_the_reference():
    assert cm.sod_breakdown() == jcm.sod_breakdown()
    assert list(cm.ACCELERATORS) == list(jcm.ACCELERATORS)
    for name in ("ESE_CAL", "SCNN_CAL", "SNAP_CAL", "SIGMA_CAL"):
        assert dataclasses.asdict(getattr(cm, name)) == dataclasses.asdict(
            getattr(jcm, name))
    for name in ("N_MACS", "SRAM_BYTES", "FREQ", "VALUE_BITS", "INDEX_BITS",
                 "DECOMP_AREA_FRACTION", "DECOMP_ENERGY_PER_NZ"):
        assert getattr(cm, name) == getattr(jcm, name)
    w = cm.Workload(7, 9, 11, 0.5, 0.25, "x")
    assert w.dense_macs == jcm.Workload(7, 9, 11, 0.5, 0.25, "x").dense_macs


def test_all_paper_claims_reproduced_under_the_port(monkeypatch):
    """The reference's claim table, every claim passing with the port's cost
    model, Workload and profiles patched into the benchmark modules."""
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import paper_figs, paper_real_models

    for mod in (paper_figs, paper_real_models):
        monkeypatch.setattr(mod, "cm", cm)
        monkeypatch.setattr(mod, "Workload", cm.Workload)
    monkeypatch.setattr(paper_real_models, "PAPER_PROFILES", pruning.PAPER_PROFILES)
    assert {k: dataclasses.asdict(v) for k, v in pruning.PAPER_PROFILES.items()} == {
        k: dataclasses.asdict(v) for k, v in jpruning.PAPER_PROFILES.items()}
    failures, n = [], 0
    for fn in paper_figs.ALL + paper_real_models.ALL:
        _, checks = fn()
        n += len(checks)
        failures += [c[0] for c in checks if not c[3]]
    assert n > 0 and not failures, failures


def _load(path: pathlib.Path, name: str, monkeypatch):
    """A script as a module, registered under ``name`` while the test runs
    (its dataclasses look their module up)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, name, mod)
    spec.loader.exec_module(mod)
    return mod


def test_card_rates_have_one_source(monkeypatch):
    """The autotuner's CUDA prior, chip_smoke.py's bound and the probe's
    bound read H100_SXM."""
    h = topology.H100_SXM
    assert autotune._PEAK_FLOPS["cuda"] == h.peak_bf16_flops
    assert autotune._MEM_BW["cuda"] == h.hbm_bandwidth
    probe = _load(ROOT / "scripts" / "sod_matmul_probe.py", "_test_probe", monkeypatch)
    assert (probe.HBM_BYTES_PER_S, probe.PEAK_BF16_OPS_PER_S) == (
        h.hbm_bandwidth, h.peak_bf16_flops)
    monkeypatch.setattr(sys, "path", list(sys.path))     # chip_smoke prepends src
    smoke = _load(ROOT / "chip_smoke.py", "_test_chip_smoke", monkeypatch)
    assert smoke.HBM_BYTES_PER_S == h.hbm_bandwidth
    assert smoke.PEAK_OPS_PER_S[torch.bfloat16] == h.peak_bf16_flops
    assert smoke.PEAK_OPS_PER_S[torch.float32] == 67e12
