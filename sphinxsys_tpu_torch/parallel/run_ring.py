"""Run the distributed block-engine dambreak (parallel/block_domain.py)
on a ring of ranks, and write what each process holds.

One process, a ThreadRing of n ranks (the CPU, or n ranks sharing one
card):

    python -m sphinxsys_tpu_torch.parallel.run_ring --ranks 4 \\
        --device cuda --dx 0.0025 --steps 3 --out build/ring

One process a rank, a ProcessGroupRing over torch.distributed (gloo on
the CPU, NCCL on cards; torchrun sets RANK, WORLD_SIZE, MASTER_ADDR and
MASTER_PORT, which take the place of --rank, --world-size and --port):

    torchrun --nproc-per-node 2 -m sphinxsys_tpu_torch.parallel.run_ring \\
        --ring process --device cpu --dx 0.1 --steps 3 --out build/ring

Each process writes <out>_<rank>.npz (ThreadRing: <out>_thread.npz): the
live rows' OriginalID, Position and Velocity of the pieces it holds, the
time, the acoustic sub-step count, the overflow flag and each step's
wall time (ms, synchronised; the first includes the kernels' build on
the card); it prints one summary line.  Exit 1 on an overflow.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from sphinxsys_tpu_torch.device import resolve_dtype


def run(ring, dx: float, steps: int, cap: int = 12, dtype=torch.float64,
        halo_cap: int = 128, migrate_cap: int = 64,
        c_max_loc: int | None = None) -> dict:
    """`steps` distributed advection steps of the 2D block dambreak from
    its start; the numpy record of this process's pieces."""
    from sphinxsys_tpu_torch.cases import dambreak_2d as db
    from sphinxsys_tpu_torch.parallel import block_domain as bd

    scene, fluid = db.build_block_case(dx=dx, cap=cap, dtype=dtype,
                                       device=ring.device)
    sim = bd.distribute_block_engine(scene.eng, fluid, ring)
    step = bd.make_distributed_engine_step(
        scene.eng, ring, wall_b=scene.wall_b, bm_wall=scene.bm_wall,
        wall_dense_map=scene.wall_dense_map, halo_cap=halo_cap,
        migrate_cap=migrate_cap, c_max_loc=c_max_loc)
    wall_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        sim = step(sim)
        if ring.device.type == "cuda":
            torch.cuda.synchronize(ring.device)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    ids, pos, vel = [], [], []
    for piece in sim.fluid:
        a = piece["Alive"]
        ids.append(piece["OriginalID"][a].cpu().numpy())
        pos.append(piece["Position"][a].cpu().numpy())
        vel.append(piece["Velocity"][a].cpu().numpy())
    return {"ids": np.concatenate(ids), "Position": np.concatenate(pos),
            "Velocity": np.concatenate(vel), "time": float(sim.time),
            "n_ac": sim.n_ac, "overflow": bool(sim.overflow),
            "n_fluid": int(fluid["NReal"]), "wall_ms": np.asarray(wall_ms)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ring", choices=("thread", "process"), default="thread")
    p.add_argument("--ranks", type=int, default=4,
                   help="ThreadRing ranks (--ring thread)")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world-size", type=int, default=None)
    p.add_argument("--addr", default="localhost")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="float64")
    p.add_argument("--dx", type=float, default=0.05)
    p.add_argument("--cap", type=int, default=12)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--halo-cap", type=int, default=128)
    p.add_argument("--migrate-cap", type=int, default=64)
    p.add_argument("--c-max-loc", type=int, default=None,
                   help="a slab's occupied-cell capacity (default: "
                   "block_domain.default_c_max_loc)")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    from sphinxsys_tpu_torch.parallel import mesh

    if a.ring == "thread":
        ring, tag = mesh.ThreadRing(a.ranks, a.device), "thread"
    else:
        import torch.distributed as dist

        rank = int(os.environ.get("RANK", -1 if a.rank is None else a.rank))
        world = int(os.environ.get("WORLD_SIZE",
                                   -1 if a.world_size is None else a.world_size))
        addr = os.environ.get("MASTER_ADDR", a.addr)
        port = os.environ.get("MASTER_PORT", a.port)
        if rank < 0 or world < 1 or port is None:
            p.error("--ring process needs a rank, a world size and a port "
                    "(or torchrun's environment)")
        device = a.device
        if device == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group("nccl" if device.startswith("cuda") else "gloo",
                                init_method=f"tcp://{addr}:{port}",
                                world_size=world, rank=rank)
        ring, tag = mesh.ProcessGroupRing(device), str(rank)
    try:
        rec = run(ring, a.dx, a.steps, cap=a.cap, dtype=resolve_dtype(a.dtype),
                  halo_cap=a.halo_cap, migrate_cap=a.migrate_cap,
                  c_max_loc=a.c_max_loc)
    finally:
        if a.ring == "process":
            import torch.distributed as dist

            dist.destroy_process_group()
    np.savez(f"{a.out}_{tag}.npz", **rec)
    print(f"run_ring {tag}: {len(rec['ids'])} live rows, n_ac {rec['n_ac']}, "
          f"t {rec['time']:.9e}, overflow {rec['overflow']}, step wall ms "
          f"{[round(float(w), 3) for w in rec['wall_ms']]}", flush=True)
    return 1 if rec["overflow"] else 0


if __name__ == "__main__":
    sys.exit(main())
