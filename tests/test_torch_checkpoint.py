"""The port's checkpoint.py against the JAX package's, on the CPU.

- problem_fingerprint gives the same string in both packages.
- A file holds the same keys whichever package wrote it (a key that
  differs would break resuming across packages without an error from
  either), and a state read back has the template's types, dtypes and
  values.
- A checkpoint written by the JAX package's PDHG or Mirror Prox resumes
  in the port, and the other way round, ending OPTIMAL at the same
  solution to 1e-8.
"""

import dataclasses

import numpy as np
import pytest
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu import checkpoint as jx_ckpt
from firstorderlp_tpu.models import mirror_prox as jx_mp
from firstorderlp_tpu.models import pdhg as jx_pdhg

import firstorderlp_torch as tx
from firstorderlp_torch import checkpoint as tx_ckpt
from firstorderlp_torch.models import mirror_prox as tx_mp
from firstorderlp_torch.models import pdhg as tx_pdhg

import fixtures
from test_mirror_prox import LP_OPT_DUAL, LP_OPT_PRIMAL, mp_params
from test_torch_mirror_prox import port_mp_params
from test_torch_pdhg import pagerank, port_params, port_problem
from utils import (
    optimality_criteria,
    pdhg_params,
    terminate_on_iteration_limit,
)

OPTIMAL = "TERMINATION_REASON_OPTIMAL"


@pytest.mark.parametrize("name", ["example_lp", "example_qp", "pagerank"])
def test_problem_fingerprint_matches(name):
    p = pagerank() if name == "pagerank" else getattr(fixtures, name)()
    got = tx_ckpt.problem_fingerprint(port_problem(p))
    assert got == jx_ckpt.problem_fingerprint(p)
    assert len(got) == 64
    other = dataclasses.replace(
        port_problem(p), right_hand_side=port_problem(p).right_hand_side + 1
    )
    assert tx_ckpt.problem_fingerprint(other) != got


# solver: (JAX module, port module, JAX parameters, port converter)
SOLVERS = {
    "pdhg": (jx_pdhg, tx_pdhg,
             lambda crit: pdhg_params(crit, ruiz_iterations=10),
             port_params),
    "mirror_prox": (jx_mp, tx_mp,
                    lambda crit: mp_params(crit, diagonal_scaling="l2",
                                           ruiz_iterations=10),
                    port_mp_params),
}


def initial_states(solver, dtype="float64"):
    jmod, tmod, make, convert_params = SOLVERS[solver]
    jparams = dataclasses.replace(make(optimality_criteria(1e-8)),
                                  dtype=dtype)
    problem = fixtures.example_lp()
    jstate = jmod.prepare_problem(jparams, problem).initial_state
    tstate = tmod.prepare_problem(
        convert_params(jparams), port_problem(problem), device="cpu"
    ).initial_state
    return jstate, tstate


def file_entries(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_both_packages_write_the_same_entries(solver, tmp_path):
    jstate, tstate = initial_states(solver)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jx_ckpt.save_state(jpath, jstate, elapsed_time=1.5, fingerprint="f")
    tx_ckpt.save_state(tpath, tstate, elapsed_time=1.5, fingerprint="f")
    want, got = file_entries(jpath), file_entries(tpath)
    assert sorted(got) == sorted(want)
    assert "avg/sum_primal_solutions" in got and "__meta__" in got
    assert bytes(got["__meta__"]) == bytes(want["__meta__"])
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert got[key].dtype.kind == w.dtype.kind, key
        np.testing.assert_allclose(got[key], w, rtol=1e-14, err_msg=key)


def leaves(state):
    return dict(tx_ckpt._leaves(state))


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_round_trip_keeps_types_dtypes_and_values(solver, tmp_path):
    _, state = initial_states(solver)
    rng = np.random.default_rng(0)
    # a state with every leaf away from its initial value
    changed = {}
    for key, leaf in leaves(state).items():
        if isinstance(leaf, torch.Tensor) and leaf.dtype.is_floating_point:
            changed[key] = torch.as_tensor(
                rng.normal(size=tuple(leaf.shape))).to(leaf.dtype)
        elif isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bool:
            changed[key] = ~leaf
        elif isinstance(leaf, torch.Tensor):
            changed[key] = leaf + 41
        elif isinstance(leaf, bool):
            changed[key] = not leaf
        else:
            changed[key] = leaf + 3
    top = {k: v for k, v in changed.items() if "/" not in k}
    for nested in ("avg", "restart_info"):
        top[nested] = dataclasses.replace(
            getattr(state, nested),
            **{k.split("/")[1]: v for k, v in changed.items()
               if k.startswith(nested + "/")},
        )
    full = dataclasses.replace(state, **top)
    path = str(tmp_path / "s.npz")
    tx_ckpt.save_state(path, full, elapsed_time=2.5,
                       metadata={"iteration": 7}, fingerprint="abc")
    back, elapsed, metadata = tx_ckpt.load_state(path, state,
                                                 fingerprint="abc")
    assert elapsed == 2.5 and metadata == {"iteration": 7}
    for key, want in leaves(full).items():
        got = leaves(back)[key]
        assert type(got) is type(want), key
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype and got.shape == want.shape, key
            assert torch.equal(got, want), key
        else:
            assert got == want, key
    if solver == "mirror_prox":
        assert back.iteration.dtype == torch.int64
        assert back.numerical_error.dtype == torch.bool
        assert back.cumulative_kkt_passes.dtype == torch.float64

    with pytest.raises(ValueError, match="different problem"):
        tx_ckpt.load_state(path, state, fingerprint="xyz")
    # a template of another compute dtype takes the file's values
    _, f32_state = initial_states(solver, dtype="float32")
    narrow, _, _ = tx_ckpt.load_state(path, f32_state)
    key = "current_primal" if solver == "mirror_prox" else (
        "current_primal_solution")
    assert getattr(narrow, key).dtype == torch.float32
    np.testing.assert_allclose(getattr(narrow, key).numpy(),
                               getattr(full, key).numpy(), rtol=1e-6)


def test_load_state_rejects_other_shapes_and_missing_leaves(tmp_path):
    _, state = initial_states("pdhg")
    path = str(tmp_path / "s.npz")
    tx_ckpt.save_state(path, state)
    wider = dataclasses.replace(state, delta_primal=torch.zeros(9))
    with pytest.raises(ValueError, match="delta_primal"):
        tx_ckpt.load_state(path, wider)
    _, mp_state = initial_states("mirror_prox")
    with pytest.raises(KeyError, match="current_primal"):
        tx_ckpt.load_state(path, mp_state)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_resume_across_packages(solver, direction, tmp_path):
    """30 iterations in one package, the rest in the other."""
    jmod, tmod, make, convert_params = SOLVERS[solver]
    problem = fixtures.example_lp()
    path = str(tmp_path / "state.npz")
    jbase = make(optimality_criteria(1e-10))
    jfirst = dataclasses.replace(
        make(terminate_on_iteration_limit(30)), checkpoint_path=path
    )
    jrest = dataclasses.replace(jbase, resume_from_checkpoint=path)
    full = tmod.optimize(convert_params(jbase), port_problem(problem),
                         device="cpu")
    if direction == "jax_to_port":
        jmod.optimize(jfirst, problem)
        out = tmod.optimize(convert_params(jrest), port_problem(problem),
                            device="cpu")
    else:
        tmod.optimize(convert_params(jfirst), port_problem(problem),
                      device="cpu")
        out = jmod.optimize(jrest, problem)
    print(f"{solver} {direction}: {out.iteration_count} iterations in all, "
          f"{full.iteration_count} without the break")
    assert out.termination_reason.name == OPTIMAL
    assert out.iteration_count > 30
    np.testing.assert_allclose(out.primal_solution, LP_OPT_PRIMAL, atol=1e-8)
    np.testing.assert_allclose(out.dual_solution, LP_OPT_DUAL, atol=1e-8)
    np.testing.assert_allclose(out.primal_solution, full.primal_solution,
                               atol=1e-8)
    np.testing.assert_allclose(out.dual_solution, full.dual_solution,
                               atol=1e-8)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_resume_in_the_port_and_wrong_problem(solver, tmp_path):
    """The port resumes its own file; a file of another problem with the
    same shapes is refused; the silent path (no stats recorded) writes
    every n-th dispatch."""
    _, tmod, make, convert_params = SOLVERS[solver]
    problem = port_problem(fixtures.example_lp())
    path = str(tmp_path / "state.npz")
    first = dataclasses.replace(
        convert_params(make(terminate_on_iteration_limit(45))),
        checkpoint_path=path, record_iteration_stats=False,
        checkpoint_every_n_dispatches=2,
    )
    tmod.optimize(first, problem, device="cpu")
    with np.load(path) as data:
        assert int(data["iteration"]) == 46
    rest = dataclasses.replace(
        convert_params(make(optimality_criteria(1e-9))),
        resume_from_checkpoint=path,
    )
    out = tmod.optimize(rest, problem, device="cpu")
    assert out.termination_reason.name == OPTIMAL
    np.testing.assert_allclose(out.primal_solution, LP_OPT_PRIMAL, atol=1e-6)
    other = dataclasses.replace(
        problem, objective_vector=problem.objective_vector * 2.0
    )
    with pytest.raises(ValueError, match="different problem"):
        tmod.optimize(rest, other, device="cpu")
