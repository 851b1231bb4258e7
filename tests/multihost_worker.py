"""One process of the 2-process multi-host test (tests/test_multihost.py).

Usage: python tests/multihost_worker.py PORT PROCESS_ID NUM_PROCESSES OUT
Each process contributes 2 virtual CPU devices to a 4-device global
('robot',) mesh; both build the SAME fleet pose-graph problem from a
fixed seed, run the distributed fleet_optimize (H/b psums cross the
process boundary over GRPC = the DCN stand-in), and dump the replicated
solution. The parent asserts both dumps agree with each other and with a
single-process solve — SURVEY.md §4 "multi-node without a real cluster".
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    port, pid, nproc, out = (int(sys.argv[1]), int(sys.argv[2]),
                             int(sys.argv[3]), sys.argv[4])
    from coxgraph_tpu.parallel import multihost
    multihost.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                         process_id=pid, local_cpu_devices=2)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from coxgraph_tpu.parallel import fleet as fl
    from coxgraph_tpu.solver import pose_graph as pg
    from tests.multihost_problem import CFG, build_fleet_problem

    assert len(jax.devices()) == 4, jax.devices()
    mesh = multihost.global_robot_mesh()

    fleet_np, inter_np = build_fleet_problem()
    fleet = multihost.make_global_pytree(
        fleet_np, mesh, jax.sharding.PartitionSpec("robot"))
    inter = multihost.replicate(inter_np, mesh)

    scfg = pg.SolverConfig(iterations=8)
    new_fleet, poses = fl.fleet_optimize(CFG, mesh, fleet, inter, scfg)
    np.save(out, np.asarray(poses))

    # timed WARM re-solve (2-host weak-scaling methodology): same
    # compiled program, readback-fenced; the parent compares against a
    # 1-process run
    import time
    t0 = time.perf_counter()
    _, poses2 = fl.fleet_optimize(CFG, mesh, new_fleet, inter, scfg)
    float(jnp.sum(poses2))
    print(f"WORKER_TIME {time.perf_counter() - t0:.4f}")

    # per-optimize collective payload from the compiled HLO (the DCN
    # budget of one distributed solve on this mesh)
    comm = multihost.fleet_optimize_comm_bytes(CFG, mesh, fleet, inter,
                                               scfg)
    print(f"WORKER_COMM {comm['per_optimize']}")
    print("WORKER_OK", pid)


if __name__ == "__main__":
    main()
