"""Checkpoint/restore of mapper and server state — the reference has NO
online checkpointing (persistence is end-of-run export only, SURVEY.md
§5.4); this build makes submap-collection + pose-graph state a
first-class checkpoint since preemption of shared accelerator hosts is
routine.

Format: one .npz per checkpoint holding every pytree leaf keyed by its
tree path, plus a JSON sidecar of host-side (non-array) state. Restores
require a template with the same structure — configs are code, state is
data.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import jax
import numpy as np


def _leaf_key(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "name"):
            parts.append(str(p.name))
        elif hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def save_pytree(path: str, tree: Any) -> int:
    """Write all leaves of a pytree to ``path`` (.npz). Returns bytes."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    arrays = {_leaf_key(p): np.asarray(v) for p, v in leaves}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return os.path.getsize(path)


def load_pytree(path: str, template: Any) -> Any:
    """Restore a pytree saved by save_pytree into ``template``'s
    structure/dtypes (arrays are loaded as numpy and placed on default
    devices lazily)."""
    data = np.load(path)
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for p, t in paths:
        k = _leaf_key(p)
        if k not in data:
            raise KeyError(f"checkpoint missing leaf {k}")
        arr = data[k]
        if arr.shape != np.shape(t):
            raise ValueError(
                f"leaf {k}: checkpoint shape {arr.shape} != template "
                f"{np.shape(t)}")
        leaves.append(arr)
    return jax.tree_util.tree_unflatten(treedef, leaves)


# ---------------------------------------------------------------------------
# Server checkpointing (submaps list + host dicts + constraint pool)
# ---------------------------------------------------------------------------


def save_server(dirpath: str, server) -> None:
    """Checkpoint a CoxgraphServer (server/fusion_server.py).

    Async-PGO safe: with a background solve in flight
    (ServerConfig.async_pgo), the solve thread rebinds submap poses and
    constraint state under the server's _state_lock — an unlocked save
    could record a torn mix of pre- and post-solve poses. All mutable
    state is SNAPSHOTTED under that lock (cheap: references + small
    copies); file IO happens outside it so the solve is never blocked on
    disk."""
    import contextlib

    os.makedirs(dirpath, exist_ok=True)
    lock = getattr(server, "_state_lock", None)
    with (lock if lock is not None else contextlib.nullcontext()):
        meta: Dict[str, Any] = {
            "n_submaps": len(server.submaps),
            "submaps": [
                {"sid": s.sid, "client_id": s.client_id,
                 "client_submap_id": s.client_submap_id,
                 "start_time": s.start_time, "end_time": s.end_time}
                for s in server.submaps
            ],
            "cli_ser": [[list(k), v] for k, v in server.cli_ser.items()],
            "fused": {str(k): v for k, v in server.fused.items()},
            "last_fusion_time": [[list(k), v]
                                 for k, v in server.last_fusion_time.items()],
            "in_control": server.in_control,
            "T_G_cli_ids": sorted(server.T_G_cli),
            # host-side constraint tags: row m of the pool ↔ kinds[m];
            # without them a resumed server mis-tags residuals and the
            # chain-constraint rebuild never fires
            "constraint_kinds": list(server.constraint_kinds),
        }
        constraints = server.constraints
        heights = server.heights
        frames = {f"T_G_cli_{c}": np.asarray(server.T_G_cli[c])
                  for c in server.T_G_cli}
        # jax arrays are immutable; capturing the references under the
        # lock pins a consistent pose/layer set even if the solve
        # rebinds the submap fields afterwards
        submap_data = [
            (s.sid, s.layer, np.asarray(s.T_cli_submap),
             np.asarray(s.T_G_submap), np.asarray(s.hist_stamps),
             np.asarray(s.hist_poses))
            for s in server.submaps
        ]
    with open(os.path.join(dirpath, "meta.json"), "w") as f:
        json.dump(meta, f)
    save_pytree(os.path.join(dirpath, "constraints.npz"), constraints)
    save_pytree(os.path.join(dirpath, "heights.npz"), heights)
    np.savez(os.path.join(dirpath, "frames.npz"), **frames)
    for sid, layer, T_cli, T_G, hs, hp in submap_data:
        save_pytree(os.path.join(dirpath, f"submap_{sid}_layer.npz"),
                    layer)
        np.savez(os.path.join(dirpath, f"submap_{sid}_pose.npz"),
                 T_cli_submap=T_cli, T_G_submap=T_G,
                 hist_stamps=hs, hist_poses=hp)


def load_server(dirpath: str, server) -> None:
    """Restore into a freshly-constructed CoxgraphServer (same cfg +
    clients). Clients' own mapper state is restored separately."""
    import jax.numpy as jnp

    from ..core import voxel as vx
    from ..server.fusion_server import ServerSubmap

    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    server.constraints = load_pytree(
        os.path.join(dirpath, "constraints.npz"), server.constraints)
    server.constraints = jax.tree.map(jnp.asarray, server.constraints)
    hpath = os.path.join(dirpath, "heights.npz")
    if os.path.exists(hpath):   # absent in pre-height checkpoints
        server.heights = jax.tree.map(
            jnp.asarray, load_pytree(hpath, server.heights))
        # host mirror of the pool watermark (saturation accounting)
        server._n_heights = min(int(server.heights.count),
                                server.heights.capacity)
    if "constraint_kinds" in meta:   # absent in pre-r3 checkpoints
        server.constraint_kinds = list(meta["constraint_kinds"])
    else:
        # legacy checkpoint: tags are unrecoverable; mark rows unknown so
        # lengths still line up with the pool watermark
        n = min(int(server.constraints.count), server.constraints.capacity)
        server.constraint_kinds = ["unknown"] * n
    frames = np.load(os.path.join(dirpath, "frames.npz"))
    for c in meta["T_G_cli_ids"]:
        # host numpy: the server control plane is host math (ServerSubmap)
        server.T_G_cli[int(c)] = np.asarray(frames[f"T_G_cli_{c}"],
                                            np.float32)
    server.cli_ser = {tuple(k): v for k, v in meta["cli_ser"]}
    server.fused = {int(k): v for k, v in meta["fused"].items()}
    server.last_fusion_time = {tuple(k): v
                               for k, v in meta["last_fusion_time"]}
    server.in_control = meta["in_control"]
    server.submaps = []
    template = vx.create_tsdf_layer(server.cfg.spec)
    for sm_meta in meta["submaps"]:
        sid = sm_meta["sid"]
        layer = load_pytree(
            os.path.join(dirpath, f"submap_{sid}_layer.npz"), template)
        layer = jax.tree.map(jnp.asarray, layer)
        pose = np.load(os.path.join(dirpath, f"submap_{sid}_pose.npz"))
        # re-derive the version-cached host geometry (n_blocks, aabb) —
        # overlap detection reads it instead of device state
        nb, aabb = server._submap_geom(layer)
        server.submaps.append(ServerSubmap(
            sid=sid, client_id=sm_meta["client_id"],
            client_submap_id=sm_meta["client_submap_id"], layer=layer,
            T_cli_submap=np.asarray(pose["T_cli_submap"], np.float32),
            T_G_submap=np.asarray(pose["T_G_submap"], np.float32),
            start_time=sm_meta["start_time"],
            end_time=sm_meta["end_time"],
            hist_stamps=pose["hist_stamps"],
            hist_poses=np.asarray(pose["hist_poses"]),
            n_blocks=nb, aabb=aabb))
