"""Weak/strong scaling sweeps (ref weakScalingRunScript, strongScalingRunScript).

    python -m hpccg_tpu.sweep weak   --per-chip 100 --meshes 1,2,4,8
    python -m hpccg_tpu.sweep strong --global-nz 1024 --nx 64 --ny 64 --meshes 1,2,4,8

Weak scaling fixes the per-shard block (ref: 64^3 per rank at np=1..64); strong
scaling fixes the global domain and divides nz across the mesh (ref: global
64x64x1024, nz=1024/np). Each point emits one JSON line; a final line reports
scaling efficiency (nnz/s per device relative to the 1-device point — the
BASELINE.json metric).

The sweep can also run on virtual CPU devices (--platform cpu, exercising the
real shard_map/ppermute/psum paths); published numbers must come from real
multi-GPU meshes.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hpccg_tpu.sweep")
    ap.add_argument("mode", choices=["weak", "strong"])
    ap.add_argument(
        "--meshes",
        default="1,2,4,8",
        help="comma-separated mesh specs: N (1-D z mesh) or HxZ (explicit "
        "2-D ('host','z') mesh, e.g. 2x4)",
    )
    ap.add_argument("--per-chip", type=int, default=100, help="weak: nx=ny=nz per shard")
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--global-nz", type=int, default=1024, help="strong: global nz")
    ap.add_argument("--stencil", type=int, default=27, choices=[27, 7])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--iters", type=int, default=64, help="slope-timing base iterations")
    ap.add_argument("--platform", default=None, help="cpu to force virtual devices")
    ap.add_argument(
        "--init-distributed",
        action="store_true",
        help="call jax.distributed.initialize() first (multi-host runs)",
    )
    args = ap.parse_args(argv)

    import os

    from hpccg_tpu.cli import parse_mesh

    mesh_specs = [parse_mesh(m) for m in args.meshes.split(",")]
    if args.platform == "cpu":
        want = max(nd for nd, _ in mesh_specs)
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={want}"
        )
        os.environ["JAX_PLATFORMS"] = "cpu"

    if args.init_distributed and args.platform == "cpu":
        raise SystemExit("--init-distributed and --platform cpu are mutually exclusive")

    import jax

    from hpccg_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if args.init_distributed:
        jax.distributed.initialize()
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from hpccg_tpu import ProblemConfig
    from hpccg_tpu.parallel import (
        generate_problem_sharded,
        make_distributed_cg,
        make_mesh,
        make_mesh2d,
        row_axis,
    )
    from hpccg_tpu.utils.timing import time_fn

    lead = jax.process_index() == 0  # multi-host: one writer

    def emit(obj):
        if lead:
            print(json.dumps(obj), flush=True)

    dtype = jnp.dtype(args.dtype)
    results = []
    for nd, shape2d in mesh_specs:
        if nd > len(jax.devices()):
            emit({"mesh": nd, "skipped": f"only {len(jax.devices())} devices"})
            continue
        remainder = False
        if args.mode == "weak":
            cfg = ProblemConfig(
                args.per_chip, args.per_chip, args.per_chip,
                stencil=args.stencil, dtype=dtype,
            )
        else:
            remainder = bool(args.global_nz % nd)
            # non-divisible nz: every shard carries ceil(nz/np) planes with
            # the trailing pad masked out (ref strongScalingRunScript runs
            # np up to 64 against nz=1024 — e.g. np=48 needs this)
            nz_local = -(-args.global_nz // nd)
            cfg = ProblemConfig(
                args.nx, args.ny, nz_local,
                stencil=args.stencil, dtype=dtype,
            )
        if shape2d is not None:
            mesh = make_mesh2d(*shape2d)
            axis = row_axis(mesh)
        else:
            mesh = make_mesh(nd)
            axis = "z"
        k1, k2 = args.iters + 1, 8 * args.iters + 1
        if remainder:
            from hpccg_tpu.parallel.cg import (
                generate_problem_sharded_masked,
                make_distributed_cg_masked,
            )

            backend_used = "stencil-halo-masked"
            prob = generate_problem_sharded_masked(
                cfg, mesh, nz_global=args.global_nz, axis=axis
            )
            s1 = make_distributed_cg_masked(
                cfg, mesh, nz_global=args.global_nz, max_iter=k1, axis=axis,
            )
            s2 = make_distributed_cg_masked(
                cfg, mesh, nz_global=args.global_nz, max_iter=k2, axis=axis,
            )
        else:
            backend_used = "stencil-halo"
            prob = generate_problem_sharded(cfg, mesh, axis=axis)
            s1 = make_distributed_cg(cfg, mesh, max_iter=k1, axis=axis)
            s2 = make_distributed_cg(cfg, mesh, max_iter=k2, axis=axis)
        t1 = time_fn(s1, prob.b, prob.x0, reps=3)
        t2 = time_fn(s2, prob.b, prob.x0, reps=3)
        below_res = (t2 - t1) <= 0
        per_iter = max(t2 - t1, 1e-12) / (k2 - k1)
        nnz_s = prob.total_nnz_model / per_iter
        point = {
            "mode": args.mode,
            "mesh": nd,
            **({"mesh_axes": list(mesh.axis_names)} if shape2d else {}),
            "local_dims": [cfg.nx, cfg.ny, cfg.nz],
            "backend": backend_used,
            **({"global_nz": args.global_nz, "remainder_masked": True} if remainder else {}),
            "global_nrow": prob.total_nrow,
            # None = below timer resolution (cf. the reference golden run's
            # inf MFLOPS at small sizes)
            "cg_iter_us": None if below_res else round(per_iter * 1e6, 2),
            "gnnz_per_s": None if below_res else round(nnz_s / 1e9, 2),
        }
        results.append(point)
        emit(point)

    results = [r for r in results if r["gnnz_per_s"]]
    if results:
        base = results[0]
        if args.mode == "weak":
            eff = [
                r["gnnz_per_s"] / (base["gnnz_per_s"] * r["mesh"] / base["mesh"])
                for r in results
            ]
        else:
            eff = [
                (r["gnnz_per_s"] / base["gnnz_per_s"]) / (r["mesh"] / base["mesh"])
                for r in results
            ]
        emit(
            {
                "summary": args.mode,
                "meshes": [r["mesh"] for r in results],
                "efficiency_vs_first": [round(e, 3) for e in eff],
            }
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
