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

import dataclasses
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
    # strips of the groups, n_strips, target chunks: the expected chunk
    # table, rows [first group, strip, first chunk of the strip, chunks
    # of the strip] and the sentinel [ngroups, n_strips, nchunks, 0]
    "one_chunk_a_strip": ([0, 0, 0, 2, 2], 4, 1, [
        [0, 0, 0, 1], [3, 1, 1, 1], [3, 2, 2, 1], [5, 3, 3, 1],
        [5, 4, 4, 0]]),
    "ragged": ([0, 0, 0, 0, 0, 1, 1, 3], 4, 3, [
        [0, 0, 0, 2], [2, 0, 0, 2], [5, 1, 2, 1], [7, 2, 3, 1],
        [7, 3, 4, 1], [8, 4, 5, 0]]),
    "one_group_a_chunk": ([1, 1, 2], 3, 100, [
        [0, 0, 0, 1], [0, 1, 1, 2], [1, 1, 1, 2], [2, 2, 3, 1],
        [3, 3, 4, 0]]),
    "no_groups": ([], 2, 4, [[0, 0, 0, 1], [0, 1, 1, 1], [0, 2, 2, 0]]),
    "probe_default": (probe.make_probe_inputs()["meta"][:, 0], 8,
                      probe.REDUCE_TARGET_CHUNKS, None),
}


def reduce_by_plan(plan, meta, g, v, hi, lo, hr=probe.HR):
    """The reduce in numpy, chunk by chunk as the plan cuts it: each
    chunk's groups into its own partial strip, then every strip's
    partials in chunk order. A strip that no chunk fills stays zero."""
    chunks = plan.chunks.numpy()
    y = np.zeros((plan.n_strips, hr, 128))
    for c in range(plan.nchunks):
        rows = slice(8 * chunks[c, 0], 8 * chunks[c + 1, 0])
        part = np.zeros((hr, 128))
        np.add.at(part, (hi[rows], lo[rows]),
                  g[rows].astype(np.float64) * v[rows])
        y[chunks[c, 1]] += part
    return y


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_plan_probe_reduce(case):
    """The chunk table: as expected where written out; for every case
    chunks in order that cover every group once, each inside one strip,
    every strip with at least one chunk (an empty one where no group
    names it), no chunk above the plan's cap and the chunks of a strip
    within one group of each other; and the reduce done chunk by chunk
    as the table says equals the plain version, zero on empty strips."""
    strips, n_strips, target, want = CHUNK_CASES[case]
    strips = np.asarray(strips, np.int32)
    ngroups = len(strips)
    meta = np.zeros((ngroups, 2), np.int32)
    meta[:, 0] = strips
    if ngroups:
        meta[:, 1] = np.r_[1, strips[1:] != strips[:-1]]
    plan = probe.plan_probe_reduce(torch.as_tensor(meta), n_strips, target)
    assert plan.chunks.dtype == torch.int32
    assert plan.tickets.dtype == torch.int32
    assert plan.tickets.tolist() == [0] * n_strips
    assert plan.warps == probe.REDUCE_WARPS
    chunks = plan.chunks.numpy().astype(np.int64)
    if want is not None:
        assert chunks.tolist() == want
    assert plan.nchunks == len(chunks) - 1
    assert chunks[-1].tolist() == [ngroups, n_strips, plan.nchunks, 0]
    first, strip_of = chunks[:, 0], chunks[:-1, 1]
    sizes = np.diff(first)
    assert first[0] == 0 and np.all(sizes >= 0)  # in order, every group
    assert np.all(np.diff(strip_of) >= 0)
    np.testing.assert_array_equal(np.unique(strip_of), np.arange(n_strips))
    cap = max(1, -(-ngroups // target))
    assert np.all(sizes <= cap)
    for c in range(plan.nchunks):
        assert set(strips[first[c]:first[c + 1]]) <= {strip_of[c]}
        s = strip_of[c]
        mine = np.flatnonzero(strip_of == s)
        assert chunks[c, 2] == mine[0] and chunks[c, 3] == len(mine)
        assert sizes[mine].max() - sizes[mine].min() <= 1
        if s not in strips:
            assert len(mine) == 1 and sizes[c] == 0
    if case == "probe_default":
        # about one chunk a SM, a few groups each, every strip split
        assert 100 <= plan.nchunks <= probe.REDUCE_TARGET_CHUNKS
        assert np.all(chunks[:-1, 3] > 1)
        assert probe.reduce_scratch_bytes(plan) == (
            2 * 4 * probe.HR * 128 * plan.nchunks + 16 * (plan.nchunks + 1))

    rng = np.random.default_rng(5)
    rows = 8 * ngroups
    g, v = (rng.normal(size=(rows, 128)).astype(np.float32)
            for _ in range(2))
    hi = rng.integers(0, probe.HR, (rows, 128)).astype(np.int32)
    lo = rng.integers(0, 128, (rows, 128)).astype(np.int32)
    got = reduce_by_plan(plan, meta, g, v, hi, lo)
    want_y = probe.probe_reduce_plain(
        *(torch.as_tensor(a) for a in (meta, g.astype(np.float64),
                                       v.astype(np.float64), hi, lo)),
        n_strips).numpy()
    np.testing.assert_allclose(got, want_y, rtol=1e-12, atol=1e-12)
    for s in set(range(n_strips)) - set(strips.tolist()):
        assert not got[s].any()


@pytest.mark.parametrize("fault", ["unsorted", "flag_inside_run",
                                   "flag_missing", "out_of_range", "shape",
                                   "no_warps", "too_many_warps"])
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
    warps = {"no_warps": 0, "too_many_warps": probe.MAX_REDUCE_WARPS + 1}
    meta = torch.as_tensor(meta)
    if fault in warps:  # a plan at a block size the kernel cannot take
        plan = probe.plan_probe_reduce(meta, 4)
        with pytest.raises(ValueError):
            dataclasses.replace(plan, warps=warps[fault])
    else:
        with pytest.raises(ValueError):
            probe.plan_probe_reduce(meta, 4)


def test_compare_tool_drives_the_probe_kernels():
    """ops/compare_kernels' probe layout calls both wrappers under their
    LAUNCHES names (on the CPU: the plain versions), with numpy's
    results, and its sweep's plans keep the chunk table of their target
    at another block size."""
    from firstorderlp_torch.ops import compare_kernels

    host = probe.make_probe_inputs(8 * 1024, seed=3)
    d = {k: torch.as_tensor(a) for k, a in host.items()}
    plan = probe.plan_probe_reduce(d["meta"], probe.N_STRIPS, 5)
    calls = compare_kernels.probe_products(probe, d, plan)
    assert set(calls) == set(probe.LAUNCHES)
    sid = np.repeat(host["strip_ids"], probe.GROUP_ROWS)
    np.testing.assert_array_equal(
        calls["probe_expand"]().numpy(),
        host["x_strips"][sid[:, None], host["hi"], host["lo"]])
    want = np.zeros((probe.N_STRIPS, probe.HR, 128))
    rows = np.repeat(host["meta"][:, 0], probe.GROUP_ROWS)
    np.add.at(want, (rows[:, None], host["hir"], host["lor"]),
              host["g2"].reshape(-1, 128).astype(np.float64) * host["v"])
    got = calls["probe_reduce"]()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert compare_kernels.reduce_error(d, got) <= 1e-6
    small = dataclasses.replace(plan, warps=1)
    assert torch.equal(small.chunks, plan.chunks) and small.warps == 1


def test_package_module_loads_this_version_or_the_parent(tmp_path,
                                                         monkeypatch):
    """compare_kernels.package_module: this package's module, or the
    module of the version a directory holds as firstorderlp_torch_parent
    (the one import that chip_smoke.py --parent and compare_kernels
    --parent share)."""
    from firstorderlp_torch.ops import compare_kernels

    root = tmp_path / "firstorderlp_torch_parent"
    (root / "ops").mkdir(parents=True)
    (root / "__init__.py").write_text("WHO = 'parent'\n")
    (root / "ops" / "__init__.py").write_text("")
    (root / "ops" / "probe_routed.py").write_text("WHO = 'parent probe'\n")
    monkeypatch.setattr(sys, "path", list(sys.path))
    for name in [n for n in sys.modules
                 if n.startswith("firstorderlp_torch_parent")]:
        monkeypatch.delitem(sys.modules, name)
    try:
        assert compare_kernels.package_module("ops.probe_routed") is probe
        assert compare_kernels.package_module(
            "ops.probe_routed", str(tmp_path)).WHO == "parent probe"
        assert compare_kernels.package_module(
            "", str(tmp_path)).WHO == "parent"
        assert sys.path.count(str(tmp_path)) == 1
    finally:
        for name in [n for n in sys.modules
                     if n.startswith("firstorderlp_torch_parent")]:
            del sys.modules[name]


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
