"""The port's probe (ops/probe_routed.py) against the JAX package's
benchmarking/probe_routed.py, on the CPU.

The JAX script is loaded by path (it is no package module, and it reads
sys.argv when imported) and its two Pallas kernels run in interpret mode,
as the JAX package's own tests run Pallas kernels on the CPU: the
module's `pl` is swapped for a stand-in whose pallas_call passes
interpret=True. Nothing in that file changes. The same arrays, made by
make_probe_inputs from a numpy seed, go through make_expand /
make_reduce and through the port's plain versions: P1 exact, P2 at a
relative 1e-6 on the strips that occur (the Pallas kernel never writes a
strip that no group names; the port zeroes it).
"""

import functools
import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import firstorderlp_tpu  # noqa: F401  (JAX set up as in every test here)

from firstorderlp_torch.ops import probe_routed as probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NNZ = 8192


@pytest.fixture(scope="module")
def jax_probe():
    """benchmarking/probe_routed.py with its kernels in interpret mode."""
    path = os.path.join(REPO, "benchmarking", "probe_routed.py")
    spec = importlib.util.spec_from_file_location("jax_probe_routed", path)
    module = importlib.util.module_from_spec(spec)
    argv = sys.argv
    sys.argv = [path]  # the script reads its nnz from argv at import
    try:
        spec.loader.exec_module(module)
    finally:
        sys.argv = argv
    real = module.pl
    stand_in = types.SimpleNamespace(
        **{k: getattr(real, k) for k in dir(real) if not k.startswith("__")}
    )
    stand_in.pallas_call = functools.partial(real.pallas_call, interpret=True)
    module.pl = stand_in
    return module


def tensors(host):
    return {k: torch.as_tensor(a) for k, a in host.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_make_probe_inputs_draws_what_the_script_draws(jax_probe, seed):
    """The script's own draws, in its order (main, :163-223)."""
    rng = np.random.default_rng(seed)
    ngroups = NNZ // 1024
    want = {}
    want["strip_ids"] = np.sort(rng.integers(0, 8, ngroups)).astype(np.int32)
    want["x_strips"] = rng.normal(size=(8, jax_probe.H, 128)).astype(
        np.float32)
    want["hi"] = rng.integers(0, jax_probe.H, (ngroups * 8, 128)).astype(
        np.int32)
    want["lo"] = rng.integers(0, 128, (ngroups * 8, 128)).astype(np.int32)
    want["g2"] = rng.normal(size=(NNZ // 128, 128)).astype(np.float32)
    want["src"] = rng.permutation(NNZ // 128).astype(np.int32)
    out_strip = np.sort(rng.integers(0, 8, ngroups))
    want["v"] = rng.normal(size=(ngroups * 8, 128)).astype(np.float32)
    want["hir"] = rng.integers(0, jax_probe.HR, (ngroups * 8, 128)).astype(
        np.int32)
    want["lor"] = rng.integers(0, 128, (ngroups * 8, 128)).astype(np.int32)
    got = probe.make_probe_inputs(NNZ + 500, seed)  # rounded down to groups
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
        assert got[key].dtype == value.dtype, key
    np.testing.assert_array_equal(got["meta"][:, 0], out_strip)
    first = np.r_[1, out_strip[1:] != out_strip[:-1]]
    np.testing.assert_array_equal(got["meta"][:, 1], first)
    assert (probe.H, probe.HR, probe.DEFAULT_NNZ) == (
        jax_probe.H, jax_probe.HR, 819_200)
    assert "a64" not in got
    assert probe.make_probe_inputs(1024, seed, with_f64=True)[
        "a64"].shape == (2048, 2048)


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_expand_plain_matches_the_pallas_kernel(jax_probe, seed):
    host = probe.make_probe_inputs(NNZ, seed)
    with jax.enable_x64(False):
        run = jax_probe.make_expand(NNZ // 1024, probe.N_STRIPS)
        want = np.asarray(run(*(jnp.asarray(host[k]) for k in
                                ("strip_ids", "x_strips", "hi", "lo"))))
    t = tensors(host)
    got = probe.probe_expand_plain(t["strip_ids"], t["x_strips"], t["hi"],
                                   t["lo"])
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # on CPU tensors the wrapper takes the plain version
    assert torch.equal(
        probe.probe_expand(t["strip_ids"], t["x_strips"], t["hi"], t["lo"]),
        got,
    )
    # and the script's own numpy check (:188-194)
    sid = np.repeat(host["strip_ids"], 8)
    np.testing.assert_array_equal(
        got.numpy(), host["x_strips"][sid[:, None], host["hi"], host["lo"]]
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_reduce_plain_matches_the_pallas_kernel(jax_probe, seed):
    host = probe.make_probe_inputs(NNZ, seed)
    g = host["g2"].reshape(-1, 128)
    with jax.enable_x64(False):
        run = jax_probe.make_reduce(NNZ // 1024, probe.N_STRIPS)
        want = np.asarray(run(*(jnp.asarray(a) for a in (
            host["meta"], g, host["v"], host["hir"], host["lor"]))))
    t = tensors(host)
    args = (t["meta"], t["g2"].reshape(-1, 128), t["v"], t["hir"], t["lor"])
    got = probe.probe_reduce_plain(*args, probe.N_STRIPS).numpy()
    assert got.shape == want.shape == (probe.N_STRIPS, probe.HR, 128)
    occur = np.unique(host["meta"][:, 0])
    absent = np.setdiff1d(np.arange(probe.N_STRIPS), occur)
    assert absent.size > 0  # 8 groups cannot name all 8 strips twice
    scale = np.max(np.abs(got)) + 1
    assert np.max(np.abs(got[occur] - want[occur])) / scale <= 1e-6
    assert not got[absent].any()
    assert torch.equal(probe.probe_reduce(*args, probe.N_STRIPS),
                       torch.as_tensor(got))
    # the script's own numpy check (:231-240)
    want_y = np.zeros((probe.N_STRIPS, probe.HR, 128), np.float32)
    np.add.at(want_y, (np.repeat(host["meta"][:, 0], 8)[:, None],
                       host["hir"], host["lor"]), g * host["v"])
    assert np.max(np.abs(got - want_y)) / scale <= 1e-6
    # in f64, as chip_smoke.py holds the kernel
    wide = probe.probe_reduce_plain(t["meta"], args[1].double(),
                                    t["v"].double(), t["hir"], t["lor"],
                                    probe.N_STRIPS)
    assert wide.dtype == torch.float64
    assert float((wide - torch.as_tensor(got)).abs().max()) / scale <= 1e-6


CHUNK_CASES = {
    # strips of the groups, n_strips, target chunks: expected chunk_ptr
    # and strip_chunk_ptr
    "one_chunk_a_strip": ([0, 0, 0, 2, 2], 4, 1, [0, 3, 5], [0, 1, 1, 2, 2]),
    "ragged": ([0, 0, 0, 0, 0, 1, 1, 3], 4, 3,
               [0, 3, 5, 7, 8], [0, 2, 3, 3, 4]),
    "one_group_a_chunk": ([1, 1, 2], 3, 100, [0, 1, 2, 3], [0, 0, 2, 3]),
    "no_groups": ([], 2, 4, [0], [0, 0, 0]),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_plan_probe_reduce(case):
    strips, n_strips, target, chunk_ptr, strip_chunk_ptr = CHUNK_CASES[case]
    strips = np.asarray(strips, np.int32)
    meta = np.zeros((len(strips), 2), np.int32)
    meta[:, 0] = strips
    if len(strips):
        meta[:, 1] = np.r_[1, strips[1:] != strips[:-1]]
    plan = probe.plan_probe_reduce(torch.as_tensor(meta), n_strips, target)
    assert plan.chunk_ptr.dtype == torch.int32
    assert plan.chunk_ptr.tolist() == chunk_ptr
    assert plan.strip_chunk_ptr.tolist() == strip_chunk_ptr
    assert plan.nchunks == len(chunk_ptr) - 1
    # every chunk lies inside one strip
    for c in range(plan.nchunks):
        assert len(set(strips[chunk_ptr[c]:chunk_ptr[c + 1]])) == 1


@pytest.mark.parametrize("fault", ["unsorted", "flag_inside_run",
                                   "flag_missing", "out_of_range", "shape"])
def test_plan_probe_reduce_rejects_bad_tables(fault):
    meta = np.array([[0, 1], [0, 0], [1, 1], [2, 1]], np.int32)
    if fault == "unsorted":
        meta[:, 0] = [0, 2, 1, 3]
        meta[:, 1] = 1
    elif fault == "flag_inside_run":
        meta[1, 1] = 1
    elif fault == "flag_missing":
        meta[2, 1] = 0
    elif fault == "out_of_range":
        meta[3, 0] = 4
    elif fault == "shape":
        meta = meta[:, :1]
    with pytest.raises(ValueError):
        probe.plan_probe_reduce(torch.as_tensor(meta), 4)


def test_bounds_count_each_array_once():
    """The figures of the default size: 9,964,672 and 13,244,672 bytes."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    ngroups = probe.DEFAULT_NNZ // 1024
    entries = (ngroups * 8, 128)
    ids = spec((ngroups,), torch.int32)
    xs = spec((probe.N_STRIPS, probe.H, 128), torch.float32)
    idx = spec(entries, torch.int32)
    val = spec(entries, torch.float32)
    meta = spec((ngroups, 2), torch.int32)
    assert probe.expand_bytes(ids, xs, idx, idx) == 9_964_672
    assert probe.reduce_bytes(meta, val, val, idx, idx,
                              probe.N_STRIPS) == 13_244_672
    ms, by = probe.bound_ms(13_244_672, 2 * probe.DEFAULT_NNZ)
    assert by == "bytes" and ms == pytest.approx(13_244_672 / 3.35e9)


def test_probe_needs_a_gpu():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.run_probe(1024)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main(["1024"])
