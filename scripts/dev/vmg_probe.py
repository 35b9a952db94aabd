"""Parametrized multigrid probe (consolidates the round-3 vmg320_* /
tau320_* / high_re_* series — their findings are recorded in STATUS.md
"Multigrid study" and the N=320 ladder, and productized as the
VMG_COLD_START_MAX_N warm-start prelude in models/spectral_vmg.py).

Usage:
    python scripts/dev/vmg_probe.py --solver vmg --n 320 --re 1000
    python scripts/dev/vmg_probe.py --solver fmg --n 256 --budget 40000

Prints wall time, iterations, energy, and the u/v L2 errors vs the stored
FV truth when one exists for the Reynolds number.
"""
import argparse
import logging
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

logging.basicConfig(level=logging.INFO)

import jax

from anap3_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="vmg",
                    choices=["vmg", "fmg", "fsg", "sg"])
    ap.add_argument("--n", type=int, default=320)
    ap.add_argument("--re", type=float, default=1000.0)
    ap.add_argument("--corner", default="smoothing")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--budget", type=int, default=400000)
    ap.add_argument("--metric", default="auto")
    ap.add_argument("--levels", type=int, default=3, help="n_levels")
    ap.add_argument("--chunk", type=int, default=2000,
                    help="chunk_size (iterations per host sync)")
    ap.add_argument("--coarsest", type=int, default=None,
                    help="FORCE the hierarchy's coarsest order (bypasses "
                         "the FAS resolution floor — the floor-bracketing "
                         "experiment, VERDICT r4 #8)")
    ap.add_argument("--orders", default=None,
                    help="FORCE the full hierarchy as a comma list, e.g. "
                         "'192,128' (non-halving ladders for the FAS "
                         "floor bracketing; bypasses the floor)")
    ap.add_argument("--save-npz", default=None,
                    help="save converged fields (x/y/u/v) + raw state "
                         "(su/sv/sp) to this path")
    ap.add_argument("--compare-npz", default=None,
                    help="print relative L2 drift of u/v vs a state saved "
                         "with --save-npz at the same N/basis")
    ap.add_argument("--init-npz", default=None,
                    help="warm-start from the raw state (su/sv/sp) of a "
                         "--save-npz file at the same N (isolates the FAS "
                         "floor-bias drift from cold-start effects)")
    a = ap.parse_args()

    import numpy as np

    from anap3_tpu.models.params import SpectralParameters
    from anap3_tpu.models.spectral import FSGSolver, SGSolver
    from anap3_tpu.models import spectral_vmg
    from anap3_tpu.models.spectral_vmg import FMGSolver, VMGSolver

    if a.coarsest is not None or a.orders:
        orig_build = spectral_vmg.build_vmg_levels
        forced_orders = ([int(x) for x in a.orders.split(",")]
                         if a.orders else None)

        def forced_build(params, n_fine=None, coarsest_n=None):
            if forced_orders is not None:
                return orig_build(params, n_fine, None,
                                  orders=forced_orders)
            return orig_build(params, n_fine, int(a.coarsest))

        spectral_vmg.build_vmg_levels = forced_build

    cls = {"vmg": VMGSolver, "fmg": FMGSolver, "fsg": FSGSolver,
           "sg": SGSolver}[a.solver]
    p = SpectralParameters(
        name=f"spectral_{a.solver}" if a.solver != "sg" else "spectral",
        Re=a.re, nx=a.n, ny=a.n, basis_type="chebyshev", CFL=1.5,
        beta_squared=5.0, corner_treatment=a.corner, corner_smoothing=0.15,
        tolerance=a.tol, max_iterations=a.budget, dtype="float32",
        chunk_size=a.chunk, convergence_metric=a.metric,
        multigrid="fsg" if a.solver in ("fsg", "vmg", "fmg") else "none",
        n_levels=a.levels)
    print(f"{a.solver} N={a.n} Re={a.re} device={jax.devices()[0]}",
          flush=True)
    s = cls(params=p)
    if a.init_npz:
        import jax.numpy as jnp
        from anap3_tpu.models import spectral_sg as core
        w = np.load(a.init_npz)
        dt = jnp.dtype(p.dtype)
        # --save-npz layout (su/sv/sp) or the data/steady exact-state
        # layout (raw state u/v/p — the smooth remainder in singular mode)
        ku, kv, kp = (("su", "sv", "sp") if "su" in w else ("u", "v", "p"))
        s.state = core.SpectralState(
            u=jnp.asarray(w[ku], dt), v=jnp.asarray(w[kv], dt),
            p=jnp.asarray(w[kp], dt))
        print(f"warm-started from {a.init_npz}", flush=True)
    t0 = time.time()
    s.solve()
    wall = time.time() - t0
    print(f"iters={s.metrics.iterations} converged={s.metrics.converged} "
          f"wall={wall:.1f}s", flush=True)
    try:
        errors = s.compute_validation_errors(
            str(REPO / "data" / "validation" / "fv"))
        print({k: round(float(v), 5) for k, v in errors.items()},
              flush=True)
    except Exception as exc:
        print(f"(no FV truth comparison: {exc})", flush=True)
    if a.save_npz:
        f = s.fields
        np.savez(a.save_npz, x=f.x, y=f.y, u=f.u, v=f.v,
                 su=np.asarray(s.state.u), sv=np.asarray(s.state.v),
                 sp=np.asarray(s.state.p))
        print(f"saved fields -> {a.save_npz}", flush=True)
    if a.compare_npz:
        ref = np.load(a.compare_npz)
        su = np.asarray(s.state.u, np.float64)
        if "su" in ref and ref["su"].shape == su.shape:
            ku, kv = "su", "sv"
        elif "u" in ref and ref["u"].shape == su.shape:
            ku, kv = "u", "v"        # data/steady raw-state layout
        else:
            ku = kv = None
        if ku is not None:
            ru, rv = ref[ku], ref[kv]
            du = np.linalg.norm(su - ru) / np.linalg.norm(ru)
            dv = np.linalg.norm(np.asarray(s.state.v, np.float64) - rv) \
                / np.linalg.norm(rv)
            dmax = max(np.abs(su - ru).max(),
                       np.abs(np.asarray(s.state.v, np.float64) - rv).max())
            print(f"STATE drift vs {a.compare_npz}: u={du:.3e} v={dv:.3e} "
                  f"max|d|={dmax:.3e}", flush=True)
        else:
            f = s.fields
            du = np.linalg.norm(f.u - ref["u"]) / np.linalg.norm(ref["u"])
            dv = np.linalg.norm(f.v - ref["v"]) / np.linalg.norm(ref["v"])
            print(f"drift vs {a.compare_npz}: u={du:.3e} v={dv:.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
