"""Multi-host (DCN) tier — the second half of the two-tier fabric
(SURVEY.md §5.8): intra-slice ICI collectives live in `fleet.py` /
`esdf_sharded.py` / `merge_sharded.py`; this module brings up
`jax.distributed` so those SAME programs span processes/hosts, with the
H/b psum reductions riding DCN between hosts and ICI within them.

The reference is inherently multi-machine (ROS TCPROS everywhere); here
a host is one JAX process contributing its local devices to one global
mesh, and the bus (comm/bus.py, TCP) keeps playing the topics/services
role for host-level submap hand-off.

Bring-up (per process):

    from coxgraph_tpu.parallel import multihost
    multihost.initialize("10.0.0.1:9911", num_processes=2, process_id=k)
    mesh = multihost.global_robot_mesh()
    fleet = multihost.make_global_fleet(cfg, n_robots, mesh, local_init)
    fleet, poses = fleet.fleet_optimize(...)   # psum crosses DCN

Tested without real hosts by two CPU processes on localhost
(tests/test_multihost.py) — the same shape the reference uses for
"multi-node without a real cluster" (SURVEY.md §4).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str, num_processes: int,
               process_id: int,
               local_cpu_devices: Optional[int] = None) -> None:
    """jax.distributed bring-up for one process of a multi-host
    deployment. ``local_cpu_devices`` forces the CPU backend with that
    many virtual devices (test/bring-up path; real accelerator hosts
    leave it None and contribute their devices). Must run before any other JAX
    call in the process."""
    if local_cpu_devices is not None:
        flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
                 if not f.startswith("--xla_force_host_platform"
                                     "_device_count")]
        flags.append(f"--xla_force_host_platform_device_count="
                     f"{local_cpu_devices}")
        os.environ["XLA_FLAGS"] = " ".join(flags)
        jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_robot_mesh(n_robots: Optional[int] = None) -> Mesh:
    """1-D ('robot',) mesh over the GLOBAL device set (all hosts).
    jax.devices() enumerates every process's devices after
    jax.distributed.initialize — collectives over the mesh cross DCN at
    host boundaries automatically."""
    devs = jax.devices()
    n = n_robots or len(devs)
    assert n <= len(devs), f"{n} robots > {len(devs)} global devices"
    return Mesh(np.array(devs[:n]), ("robot",))


def make_global_array(shape, mesh: Mesh, spec: P,
                      fill: Callable[[tuple], np.ndarray], dtype=None):
    """Build a GLOBAL array on a multi-host mesh: every process calls
    this with the same (shape, spec, fill); ``fill(index)`` returns the
    numpy data for one addressable shard (index = the global slice
    tuple). Single-process meshes work too (plain device_put path)."""
    sharding = NamedSharding(mesh, spec)

    def cb(index):
        out = np.asarray(fill(index))
        return out if dtype is None else out.astype(dtype)

    return jax.make_array_from_callback(tuple(shape), sharding, cb)


def make_global_pytree(template, mesh: Mesh, leading_spec: P):
    """Shard a pytree's leaves along their leading axis over the mesh.
    Every process passes an IDENTICAL host tree (computed from a shared
    seed); each contributes the slices its devices own."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    out = []
    for leaf in leaves:
        arr = np.asarray(leaf)
        out.append(make_global_array(
            arr.shape, mesh, leading_spec,
            lambda idx, a=arr: a[idx], dtype=arr.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")

_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1,
                "u8": 1, "pred": 1}


def collective_payload_bytes(hlo_text: str) -> dict:
    """Parse compiled HLO → {collective kind: payload bytes} summed over
    every cross-device collective instruction (node_evaluator-style comm
    accounting, but derived from the PROGRAM: the reference samples what
    its transport moved, evaluation_config.yaml:1-9; XLA's collectives
    aren't observable from Python at runtime, so the compiled HLO is the
    ground truth of what each execution moves).

    Note: an instruction inside a `while` body is counted ONCE — scale
    by the loop's trip count (e.g. SolverConfig.iterations for the GN
    loop) for per-call totals. On a mesh spanning H hosts, every listed
    byte crosses the DCN boundary at least once per execution (ring
    reductions ship each element across every inter-host link).

    Handles single-array shapes, TUPLE-shaped combined collectives
    (XLA's AllReduceCombiner merges e.g. the solver's H and b psums into
    one `(f32[...], f32[...]) all-reduce`), and async `-start` forms
    (the matching `-done` re-stages the same payload and is NOT counted
    again) — ADVICE r3. Async `-start` tuple semantics are KIND-AWARE
    (ADVICE r4): all-reduce-start's tuple members are independent
    combined payloads (sum them — same accounting as the sync form, the
    solver's H+b psum being the primary case), while
    all-gather/collective-permute/reduce-scatter/all-to-all `-start`
    tuples re-list operand next to result (take the largest member, the
    transfer size)."""
    import re

    shape_re = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
    inst_re = re.compile(
        r"=\s*([^\n=]+?)\s*\b(" + "|".join(_COLLECTIVES) +
        r")(-start)?\(")
    out: dict = {}
    for m in inst_re.finditer(hlo_text):
        lhs, kind, is_start = m.group(1), m.group(2), m.group(3)
        sizes = []
        for dtype, dims in shape_re.findall(lhs):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            sizes.append(n * _DTYPE_BYTES.get(dtype, 4))
        dedup = bool(is_start) and kind != "all-reduce"
        total = (max(sizes) if dedup else sum(sizes)) if sizes else 0
        if total:
            out[kind] = out.get(kind, 0) + total
    return out


def fleet_optimize_comm_bytes(cfg, mesh: Mesh, fleet, inter_robot,
                              solver_cfg) -> dict:
    """Per-optimize collective payload of `fleet.fleet_optimize` on this
    mesh: lower+compile (cache-friendly) and account the HLO →
    {"per_iteration": {kind: bytes}, "per_optimize": total bytes across
    the solver's GN iterations}. This is the network budget of one
    distributed solve when the mesh spans hosts (BASELINE 2-host row
    methodology)."""
    from . import fleet as fl

    compiled = fl.fleet_optimize.lower(
        cfg, mesh, fleet, inter_robot, solver_cfg).compile()
    per_iter = collective_payload_bytes(compiled.as_text())
    return {
        "per_iteration": per_iter,
        "per_optimize": sum(per_iter.values()) * solver_cfg.iterations,
    }


def replicate(x, mesh: Mesh):
    """Fully-replicated global placement of a host-identical pytree
    (every process must hold the same values — e.g. inter-robot
    constraints computed from shared data)."""
    return jax.tree.map(
        lambda a: make_global_array(
            np.asarray(a).shape, mesh, P(),
            lambda idx, arr=np.asarray(a): arr[idx],
            dtype=np.asarray(a).dtype),
        x)
