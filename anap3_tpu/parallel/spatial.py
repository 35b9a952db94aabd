"""Tensor-parallel spectral stepping: one large solve sharded across devices.

The reference has no per-solve domain decomposition (problem sizes fit one
host); this module exists for the scaling axis SURVEY §5 ("long-context")
calls for: at large N, shard the x-axis of every field over a device mesh
axis and express the x-direction derivative matmuls as
psum_scatter collectives, while y-direction matmuls stay shard-local.

Formulation (all state arrays (N+1, N+1), rows = x index, sharded over the
mesh axis ``x``; the PN-PN-2 inner-grid pressure is EMBEDDED in a full-grid
array with zero boundary ring so that every array shares one sharding and no
cross-shard slicing is needed):

    du/dy  = U_loc @ Dy^T            (local)
    du/dx  = psum_scatter(Dx_cols_loc @ U_loc)   (one collective)
    dp/dx  = psum_scatter(GxP_cols_loc @ P_loc) @ IyP^T
    dp/dy  = psum_scatter(IxP_cols_loc @ P_loc) @ GyP^T

with GxP = Dx @ IxP, IxP the inner->full interpolation padded with zero
boundary columns. A batch (sweep/dp) axis composes on the leading dimension.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.params import SpectralParameters
from ..models import spectral_sg as core

__all__ = ["ShardedSpectralOps", "build_sharded_ops", "make_sharded_step",
           "make_sharded_chunk_runner", "make_step_ops_spec", "shard_state",
           "pad_pressure", "unpad_pressure", "spatial_mesh_from_config"]


def spatial_mesh_from_config(machine_cfg: dict, nf: int):
    """Build the tensor-parallel mesh requested by ``machine.mesh_axes``.

    Returns a Mesh with a single ``x`` axis over as many devices as divide
    the row count ``nf``, or None when the config does not request spatial
    sharding / only one device is usable.
    """
    axes = machine_cfg.get("mesh_axes") or []
    if "x" not in axes:
        return None
    devices = jax.devices()
    n = len(devices)
    while n > 1 and nf % n != 0:
        n -= 1
    if n <= 1:
        return None
    return Mesh(np.array(devices[:n]), ("x",))

_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)


@jax.tree_util.register_pytree_node_class
@dataclass
class ShardedSpectralOps:
    """Operator set for the sharded step (padded-pressure formulation)."""

    Dx: jnp.ndarray      # (nf, nf) — sharded by columns
    Dxx: jnp.ndarray     # (nf, nf) — sharded by columns
    DyT: jnp.ndarray     # (nf, nf) — replicated
    DyyT: jnp.ndarray    # (nf, nf) — replicated
    GxP: jnp.ndarray     # (nf, nf) = Dx @ IxP — sharded by columns
    IxP: jnp.ndarray     # (nf, nf) padded interpolation — sharded by columns
    IyPT: jnp.ndarray    # (nf, nf) — replicated
    GyPT: jnp.ndarray    # (nf, nf) = (Dy @ IyP)^T — replicated
    bc_u: jnp.ndarray    # (nf, nf) — sharded by rows
    bc_v: jnp.ndarray
    interior: jnp.ndarray   # velocity interior mask — sharded by rows
    p_mask: jnp.ndarray     # inner-grid mask for the padded pressure
    W2d: jnp.ndarray        # quadrature weights — sharded by rows
    nu: jnp.ndarray
    beta_sq: jnp.ndarray
    CFL: jnp.ndarray
    lid_velocity: jnp.ndarray
    inv_dx_min: jnp.ndarray
    inv_dy_min: jnp.ndarray

    _FIELDS = ("Dx", "Dxx", "DyT", "DyyT", "GxP", "IxP", "IyPT", "GyPT",
               "bc_u", "bc_v", "interior", "p_mask", "W2d", "nu", "beta_sq",
               "CFL", "lid_velocity", "inv_dx_min", "inv_dy_min")

    def tree_flatten(self):
        return tuple(getattr(self, f) for f in self._FIELDS), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _pad_cols(M: np.ndarray) -> np.ndarray:
    """(nf, ni) -> (nf, nf) with zero first/last columns."""
    nf = M.shape[0]
    out = np.zeros((nf, nf))
    out[:, 1:-1] = M
    return out


def build_sharded_ops(params: SpectralParameters, n: int | None = None,
                      dtype=jnp.float32) -> Tuple[ShardedSpectralOps, dict]:
    base_ops, grid = core.build_spectral_ops(params, n=n, dtype=dtype)
    nf = grid["shape_full"][0]
    IxP = _pad_cols(np.asarray(grid["Ix"]))
    IyP = _pad_cols(np.asarray(grid["Iy"]))
    GxP = np.asarray(grid["Dx"]) @ IxP
    GyP = np.asarray(grid["Dy"]) @ IyP
    p_mask = np.zeros((nf, nf))
    p_mask[1:-1, 1:-1] = 1.0

    cast = lambda a: jnp.asarray(np.asarray(a), dtype=dtype)
    ops = ShardedSpectralOps(
        Dx=cast(grid["Dx"]), Dxx=cast(grid["Dxx"]),
        DyT=cast(np.asarray(grid["Dy"]).T), DyyT=cast(np.asarray(grid["Dyy"]).T),
        GxP=cast(GxP), IxP=cast(IxP), IyPT=cast(IyP.T), GyPT=cast(GyP.T),
        bc_u=cast(base_ops.bc_u), bc_v=cast(base_ops.bc_v),
        interior=cast(np.asarray(base_ops.interior, dtype=float)),
        p_mask=cast(p_mask), W2d=cast(base_ops.W2d),
        nu=cast(base_ops.nu), beta_sq=cast(base_ops.beta_sq),
        CFL=cast(base_ops.CFL), lid_velocity=cast(base_ops.lid_velocity),
        inv_dx_min=cast(base_ops.inv_dx_min), inv_dy_min=cast(base_ops.inv_dy_min),
    )
    return ops, grid


def pad_pressure(p_inner: jnp.ndarray) -> jnp.ndarray:
    nf = p_inner.shape[-1] + 2
    out = jnp.zeros(p_inner.shape[:-2] + (nf, nf), p_inner.dtype)
    return out.at[..., 1:-1, 1:-1].set(p_inner)


def unpad_pressure(p_pad: jnp.ndarray) -> jnp.ndarray:
    return p_pad[..., 1:-1, 1:-1]


def _dx_apply(ops_or_A, F_rows, x_axis):
    """x-direction operator apply: local partial product + psum_scatter."""
    partial_full = _mm(ops_or_A, F_rows)
    return jax.lax.psum_scatter(partial_full, x_axis,
                                scatter_dimension=0, tiled=True)


def _rk4_local(ops: ShardedSpectralOps, u, v, p, x_axis):
    """One RK4 pseudo-timestep on LOCAL row blocks (inside shard_map).

    Returns (u, v, p, (R_u, R_v, R_p)) with the last stage's residuals for
    the runner's algebraic-residual metrics.
    """
    def residuals(u, v, p):
        du_dy = _mm(u, ops.DyT)
        dv_dy = _mm(v, ops.DyT)
        du_dx = _dx_apply(ops.Dx, u, x_axis)
        dv_dx = _dx_apply(ops.Dx, v, x_axis)
        lap_u = _dx_apply(ops.Dxx, u, x_axis) + _mm(u, ops.DyyT)
        lap_v = _dx_apply(ops.Dxx, v, x_axis) + _mm(v, ops.DyyT)
        dp_dx = _mm(_dx_apply(ops.GxP, p, x_axis), ops.IyPT)
        dp_dy = _mm(_dx_apply(ops.IxP, p, x_axis), ops.GyPT)
        R_u = -(u * du_dx + v * du_dy) - dp_dx + ops.nu * lap_u
        R_v = -(u * dv_dx + v * dv_dy) - dp_dy + ops.nu * lap_v
        R_p = -ops.beta_sq * (du_dx + dv_dy) * ops.p_mask
        return R_u, R_v, R_p

    def enforce(u, v):
        u = ops.interior * u + (1.0 - ops.interior) * ops.bc_u
        v = ops.interior * v + (1.0 - ops.interior) * ops.bc_v
        return u, v

    # global CFL timestep: local max + all-reduce
    u_max_l = jnp.max(jnp.abs(u))
    v_max_l = jnp.max(jnp.abs(v))
    u_max = jnp.maximum(jax.lax.pmax(u_max_l, x_axis), ops.lid_velocity)
    v_max = jnp.maximum(jax.lax.pmax(v_max_l, x_axis),
                        jnp.asarray(1e-10, u.dtype))
    lam_x = (u_max + jnp.sqrt(u_max**2 + ops.beta_sq)) * ops.inv_dx_min \
        + ops.nu * ops.inv_dx_min**2
    lam_y = (v_max + jnp.sqrt(v_max**2 + ops.beta_sq)) * ops.inv_dy_min \
        + ops.nu * ops.inv_dy_min**2
    dt = ops.CFL / (lam_x + lam_y)

    u0, v0, p0 = u, v, p
    R_u = R_v = R_p = None
    for alpha in (0.25, 1.0 / 3.0, 0.5, 1.0):
        R_u, R_v, R_p = residuals(u, v, p)
        u = u0 + (alpha * dt) * R_u
        v = v0 + (alpha * dt) * R_v
        p = (p0 + (alpha * dt) * R_p) * ops.p_mask
        u, v = enforce(u, v)
    return u, v, p, (R_u, R_v, R_p)


def make_sharded_step(mesh: Mesh, x_axis: str = "x",
                      batch_axis: str | None = None):
    """Build the jitted shard_map'd RK4 step.

    State = (u, v, p_pad), each (..., nf, nf) with the row (x) dimension
    sharded over ``x_axis`` and the optional leading batch dimension sharded
    over ``batch_axis``. The ops pytree is passed with matching shardings
    (column-sharded matrices where noted in ShardedSpectralOps).
    """

    def local_step(ops: ShardedSpectralOps, u, v, p):
        u, v, p, _R = _rk4_local(ops, u, v, p, x_axis)
        return u, v, p

    ops_spec = make_step_ops_spec(x_axis)
    b = (batch_axis,) if batch_axis else ()
    row_b = P(*b, x_axis, None)
    state_spec = (row_b, row_b, row_b)

    fn = local_step
    if batch_axis:
        fn = jax.vmap(local_step, in_axes=(None, 0, 0, 0))

    from jax import shard_map

    sharded = shard_map(
        fn, mesh=mesh,
        in_specs=(ops_spec, *state_spec),
        out_specs=state_spec,
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_chunk_runner(mesh: Mesh, ops_sharded: ShardedSpectralOps,
                              chunk: int, tolerance: float, warmup: int = 10,
                              x_axis: str = "x",
                              convergence_metric: str = "rel_iter"):
    """Chunked convergence runner over the sharded step.

    Drop-in for ``models.runner.run_fixed_point``'s ``chunk_runner``
    contract — ``chunk_fn(state, start_iter, ref_norm) -> (state, done,
    conv_iter, converged, rows, ref_norm)`` — where ``state`` is the
    (u, v, p_padded) tuple with rows sharded over ``mesh[x_axis]``. All
    convergence/metric reductions are global (psum over the mesh axis), so
    the loop semantics are bit-compatible with the single-device runner:
    relative-iterate (or normalized-residual) criterion, warmup gate,
    done-freezing, NaN divergence detection, per-step metric rows.
    """
    from jax import shard_map

    use_residual = convergence_metric == "residual"
    chunk = int(chunk)

    def local_chunk(ops, u, v, p, start_iter, ref_norm):
        def gsum(a):
            return jax.lax.psum(jnp.sum(a), x_axis)

        def gnorm(a):
            return jnp.sqrt(gsum(a * a))

        def body(carry, offset):
            u, v, p, done, conv_iter, ref_norm = carry
            idx = (start_iter + offset).astype(jnp.int32)
            u_n, v_n, p_n, (R_u, R_v, R_p) = _rk4_local(ops, u, v, p, x_axis)

            rel = jnp.maximum(gnorm(u_n - u) / (gnorm(u) + 1e-12),
                              gnorm(v_n - v) / (gnorm(v) + 1e-12))
            omega = _dx_apply(ops.Dx, v_n, x_axis) - _mm(u_n, ops.DyT)
            dwx = _dx_apply(ops.Dx, omega, x_axis)
            dwy = _mm(omega, ops.DyT)
            W = ops.W2d
            cont = gnorm(R_p)
            nan = jnp.asarray(jnp.nan, u.dtype)
            frozen = done
            row = jnp.stack([
                jnp.where(frozen, nan, rel),
                jnp.where(frozen, nan, gnorm(R_u)),
                jnp.where(frozen, nan, gnorm(R_v)),
                jnp.where(frozen, nan, cont),
                jnp.where(frozen, nan,
                          0.5 * gsum(W * (u_n * u_n + v_n * v_n))),
                jnp.where(frozen, nan, 0.5 * gsum(W * omega * omega)),
                jnp.where(frozen, nan,
                          0.5 * gsum(W * (dwx * dwx + dwy * dwy))),
            ])

            if use_residual:
                ref_norm = jnp.where(idx == warmup, cont, ref_norm)
                crit = cont / jnp.maximum(ref_norm, 1e-30)
            else:
                crit = rel
            finite = jnp.isfinite(rel)
            newly_conv = (idx >= warmup) & (crit < tolerance) & finite
            newly_div = ~finite & ~done
            now_done = done | newly_conv | newly_div
            conv_iter = jnp.where(~done & now_done, idx + 1, conv_iter)

            keep = lambda new, old: jnp.where(done, old, new)
            return (keep(u_n, u), keep(v_n, v), keep(p_n, p),
                    now_done, conv_iter, ref_norm), (row, newly_conv)

        init = (u, v, p, jnp.asarray(False), jnp.asarray(-1, jnp.int32),
                ref_norm)
        (u, v, p, done, conv_iter, ref_norm), (rows, conv_flags) = \
            jax.lax.scan(body, init, jnp.arange(chunk))
        converged = jnp.any(conv_flags)
        return u, v, p, done, conv_iter, converged, rows, ref_norm

    row_spec = P(x_axis, None)
    rep = P()
    sharded = shard_map(
        local_chunk, mesh=mesh,
        in_specs=(make_step_ops_spec(x_axis), row_spec, row_spec, row_spec,
                  rep, rep),
        out_specs=(row_spec, row_spec, row_spec, rep, rep, rep, rep, rep),
        check_vma=False,
    )
    jit_sharded = jax.jit(sharded)

    def chunk_fn(state, start_iter, ref_norm):
        u, v, p = state
        u, v, p, done, conv_iter, converged, rows, ref_norm = jit_sharded(
            ops_sharded, u, v, p, jnp.asarray(start_iter, jnp.int32),
            jnp.asarray(ref_norm, u.dtype))
        return (u, v, p), done, conv_iter, converged, rows, ref_norm

    return chunk_fn


def make_step_ops_spec(x_axis: str = "x") -> ShardedSpectralOps:
    """PartitionSpec pytree matching ShardedSpectralOps for shard_map/device_put."""
    row = P(x_axis, None)
    col = P(None, x_axis)
    rep = P()
    return ShardedSpectralOps(
        Dx=col, Dxx=col, DyT=rep, DyyT=rep,
        GxP=col, IxP=col, IyPT=rep, GyPT=rep,
        bc_u=row, bc_v=row, interior=row, p_mask=row, W2d=row,
        nu=rep, beta_sq=rep, CFL=rep, lid_velocity=rep,
        inv_dx_min=rep, inv_dy_min=rep,
    )


def shard_state(mesh: Mesh, arrays, x_axis: str = "x",
                batch_axis: str | None = None):
    """device_put state arrays with the row sharding the step expects."""
    b = (batch_axis,) if batch_axis else ()
    spec = P(*b, x_axis, None)
    return tuple(jax.device_put(a, NamedSharding(mesh, spec)) for a in arrays)
