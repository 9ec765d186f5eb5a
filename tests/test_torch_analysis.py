"""The port's analytic yardsticks (``repro_torch.analysis``) against
``repro.analysis``: the memory models, ``model_flops``, the halo wire
bytes and ``roofline_terms`` return the reference's values on every
architecture of ``configs/``, every ``INPUT_SHAPES`` entry and the meshes
``{}``, ``{"data": 8}`` and ``{"data": 4, "model": 2}``, with ``fsdp``,
``n_micro`` and ``worker_axis`` varied; and the port's own constants.

Tolerances: none. The byte terms are the reference's arithmetic on the
same integers, so every rounded figure is equal to its rounding and every
integer and float equal. The one intended difference is the fit flag:
the port's ``fits_hbm`` judges the total against the H100's 80 GB, the
reference's ``fits_16gb`` against 16 GB; it is held on its own.
"""
import itertools

import pytest
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import repro.analysis.memory_model as jmm
import repro.analysis.roofline as jrl
import repro.configs as jcfg
import repro_torch.analysis as ta
import repro_torch.analysis.memory_model as tmm
import repro_torch.analysis.roofline as trl
import repro_torch.configs as tcfg

MESHES = ({}, {"data": 8}, {"data": 4, "model": 2})
SHAPES = sorted(tcfg.INPUT_SHAPES)


def _same(port: dict, ref: dict, flag: str = "fits_16gb") -> None:
    """Every term equal; the fit flag judged on its own."""
    assert set(port) - {"fits_hbm"} == set(ref) - {flag}
    for k, v in ref.items():
        if k != flag:
            assert port[k] == v, (k, port[k], v)


def _fits(total_gb: float) -> bool:
    return total_gb * 1e9 < 80e9


def test_hw_is_the_h100_data_sheet():
    hw = ta.HW()
    assert (hw.peak_flops, hw.fp32_flops, hw.hbm_bw, hw.hbm_bytes,
            hw.link_bw) == (989e12, 67e12, 3.35e12, 80e9, 450e9)
    assert "H100" in trl.HW.__doc__ and "700.00 W" in trl.HW.__doc__


@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_configs_are_the_references(arch):
    port, ref = tcfg.get_config(arch), jcfg.get_config(arch)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_train_memory_matches_reference(arch):
    port, ref = tcfg.get_config(arch), jcfg.get_config(arch)
    for shape, mesh, fsdp, n_micro, worker_axis, mb in itertools.product(
            SHAPES, MESHES, (False, True), (1, 4), (False, True), (4, 2)):
        args = (mesh, fsdp, n_micro, worker_axis, mb)
        got = tmm.train_memory_gb(port, tcfg.INPUT_SHAPES[shape], *args)
        want = jmm.train_memory_gb(ref, jcfg.INPUT_SHAPES[shape], *args)
        _same(got, want)
        assert got["fits_hbm"] is _fits(got["total_gb"]) or \
            abs(got["total_gb"] - 80.0) < 1e-3


@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_serve_memory_matches_reference(arch):
    port, ref = tcfg.get_config(arch), jcfg.get_config(arch)
    for shape, mesh, cache_len, gathered in itertools.product(
            SHAPES, MESHES, (2_080, 32_768, 524_288), (False, True)):
        got = tmm.serve_memory_gb(port, tcfg.INPUT_SHAPES[shape], mesh,
                                  cache_len, gathered)
        want = jmm.serve_memory_gb(ref, jcfg.INPUT_SHAPES[shape], mesh,
                                   cache_len, gathered)
        _same(got, want)


@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_model_flops_match_reference(arch):
    port, ref = tcfg.get_config(arch), jcfg.get_config(arch)
    for shape in SHAPES:
        assert trl.model_flops(port, tcfg.INPUT_SHAPES[shape]) == \
            jrl.model_flops(ref, jcfg.INPUT_SHAPES[shape])


def test_pushsum_device_memory_matches_reference():
    for N, E, d, S, K in itertools.product(
            (11, 131_072, 1 << 20), (30, 917_504, 1 << 21), (1, 4),
            (1, 2, 8), (1, 64)):
        got = tmm.pushsum_device_memory_gb(N, E, d, S, K)
        _same(got, jmm.pushsum_device_memory_gb(N, E, d, S, K))


def test_fits_hbm_judges_the_h100():
    """A Qwen3-8B train cell past 16 GB but inside 80 GB: the reference's
    flag says no, the port's yes; far past 80 GB both say no."""
    cfg, shape = tcfg.get_config("qwen3_8b"), tcfg.INPUT_SHAPES["train_4k"]
    got = tmm.train_memory_gb(cfg, shape, {"data": 64}, True, 1)
    assert 16.0 < got["total_gb"] < 80.0 and got["fits_hbm"]
    ref = jmm.train_memory_gb(jcfg.get_config("qwen3_8b"),
                              jcfg.INPUT_SHAPES["train_4k"], {"data": 64},
                              True, 1)
    assert not ref["fits_16gb"]
    huge = tmm.train_memory_gb(tcfg.get_config("llama3_405b"), shape, {},
                               False, 1)
    assert not huge["fits_hbm"]


def test_halo_wire_bytes_match_reference():
    for N, d, S, variant, sb in itertools.product(
            (11, 1 << 20), (1, 4), (1, 2, 4, 8), ("psum", "scatter"),
            (2, 4)):
        assert trl.pushsum_halo_wire_bytes(
            N, d, S, variant=variant, storage_bytes=sb) == \
            jrl.pushsum_halo_wire_bytes(N, d, S, variant=variant,
                                        storage_bytes=sb)
    with pytest.raises(ValueError, match="variant"):
        trl.pushsum_halo_wire_bytes(8, 1, 2, variant="ring")


def test_roofline_terms_match_reference_on_the_same_constants():
    hw = ta.HW()
    jhw = jrl.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                 link_bw=hw.link_bw, hbm_bytes=hw.hbm_bytes)
    for flops, nbytes, wire, n, mf in (
            (0.0, 27e6, 0.0, 1, 0.0), (2.7e14, 1.6e10, 0.0, 1, 2.68e14),
            (1e12, 1e9, 4e9, 4, 3e12), (5e15, 0.0, 0.0, 8, 0.0)):
        cost = {"flops": flops, "bytes accessed": nbytes}
        coll = {"wire_bytes_per_device": wire}
        assert trl.roofline_terms(cost, coll, n, mf, hw) == \
            jrl.roofline_terms(cost, coll, n, mf, jhw)
    # the default is the H100: a 27 MB step is 8.06 us of bytes
    t = trl.roofline_terms({"bytes accessed": 27e6},
                           {"wire_bytes_per_device": 0.0}, 1, 0.0)
    assert t["dominant"] == "memory"
    assert t["bound_step_time_s"] == pytest.approx(27e6 / 3.35e12, rel=0)
