"""The XLA step against the plain numpy reference, and the chunked runner
against a per-step Python loop."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from anap3_tpu.models import spectral_sg as core
from anap3_tpu.models.params import SpectralParameters
from anap3_tpu.models.reference import ReferenceSG, step_tolerance
from anap3_tpu.models.runner import (ENERGY_PLATEAU_CHUNKS, WARMUP_ITERS,
                                     run_fixed_point)

_step = jax.jit(core.sg_step)


def _relerr(a, b):
    a = np.asarray(a, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("lid", ["smoothing", "saad"])
@pytest.mark.parametrize("basis", ["chebyshev", "legendre"])
@pytest.mark.parametrize("n", [8, 12, 16, 24, 32, 48])
def test_sg_step_matches_numpy_reference(n, basis, lid, dtype):
    """5 RK4/AC steps from rest at Re=1000: float64 agrees to summation
    order, float32 (Precision.HIGHEST) to rounding, within the N-scaled
    bounds chip_smoke.py applies at N=128 on the card."""
    params = SpectralParameters(Re=1000.0, nx=n, ny=n, basis_type=basis,
                                corner_treatment=lid, corner_smoothing=0.15,
                                CFL=1.5, beta_squared=5.0, dtype=dtype)
    ops, _ = core.build_spectral_ops(params)
    state = core.initial_state(ops)
    ref = ReferenceSG(n, 1000.0, basis, lid, 0.15)
    for _ in range(5):
        state, _ = _step(ops, state)
        ref.step()
    assert state.u.dtype == jnp.dtype(dtype)
    err = max(_relerr(state.u, ref.u), _relerr(state.v, ref.v),
              _relerr(state.p, ref.p))
    assert err <= step_tolerance(n, dtype), err


def _per_step_loop(ops, tolerance, max_iterations, metric, chunk):
    """Literal per-iteration loop with the reference's break semantics
    (base.py:249-285) for rel_iter/residual, and the chunk-boundary
    kinetic-energy plateau test for energy."""
    state = core.initial_state(ops)
    ref_norm, e_prev, e0, plateau = None, None, None, 0
    for i in range(max_iterations):
        new, m = _step(ops, state)
        rel = max(
            float(jnp.linalg.norm(new.u - state.u)
                  / (jnp.linalg.norm(state.u) + 1e-12)),
            float(jnp.linalg.norm(new.v - state.v)
                  / (jnp.linalg.norm(state.v) + 1e-12)))
        state = new
        if metric == "rel_iter" and i >= WARMUP_ITERS and rel < tolerance:
            return i + 1, state
        if metric == "residual":
            if i == WARMUP_ITERS:
                ref_norm = float(m["continuity"])
            if i >= WARMUP_ITERS and \
                    float(m["continuity"]) / ref_norm < tolerance:
                return i + 1, state
        if metric == "energy" and (i + 1) % chunk == 0 and i + 1 > WARMUP_ITERS:
            e = float(m["energy"])
            tol = max(tolerance, np.sqrt(chunk) * np.finfo(np.float64).eps)
            if e_prev is not None and abs(e - e_prev) <= tol * abs(e):
                if plateau == 0:
                    e0 = e_prev
                plateau += 1
                if plateau >= ENERGY_PLATEAU_CHUNKS:
                    if abs(e - e0) <= tol * abs(e) * np.sqrt(plateau):
                        return i + 1, state
                    plateau = 0
            else:
                plateau = 0
            e_prev = e
    return max_iterations, state


@pytest.mark.parametrize("metric,tolerance", [
    ("rel_iter", 1e-3), ("residual", 1e-2), ("energy", 1e-3)])
def test_chunk_loop_matches_per_step_loop(metric, tolerance):
    """run_fixed_point's jitted chunks (with frozen tails and, for energy,
    host-side plateau tests at chunk boundaries) stop at the same iteration
    and state as a per-step Python loop."""
    params = SpectralParameters(Re=100.0, nx=12, ny=12, dtype="float64",
                                basis_type="chebyshev", CFL=1.5)
    ops, _ = core.build_spectral_ops(params)
    chunk = 40
    it_loop, s_loop = _per_step_loop(ops, tolerance, 3000, metric, chunk)
    res = run_fixed_point(lambda s: core.sg_step(ops, s),
                          lambda s: (s.u, s.v), core.initial_state(ops),
                          tolerance=tolerance, max_iterations=3000,
                          chunk=chunk, convergence_metric=metric,
                          energy_plateau_chunks=ENERGY_PLATEAU_CHUNKS)
    assert res.converged and it_loop < 3000
    assert res.iterations == it_loop
    np.testing.assert_allclose(np.asarray(res.state.u),
                               np.asarray(s_loop.u), rtol=0, atol=1e-12)
