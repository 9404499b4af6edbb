"""Checkpoint / resume — a capability the reference lacks entirely
(SURVEY.md section 5: training state is in-memory only; a page reload loses
everything).

A checkpoint is a single .npz with the scene parameters, the alive mask,
the Adam moments, and the iteration counter; pair with io.ply.save_ply for
an interchange-format export of the splats alone.
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np

from webdgs.core.scene import GaussianScene
from webdgs.ops.adam import AdamState, pack_rows

FORMAT_VERSION = 2


def save_checkpoint(path: str | os.PathLike, scene: GaussianScene,
                    opt_state: AdamState | None = None,
                    iteration: int | None = None,
                    extra: dict | None = None) -> None:
    arrays = {
        "means": np.asarray(scene.means),
        "quats": np.asarray(scene.quats),
        "log_scales": np.asarray(scene.log_scales),
        "opacity_logits": np.asarray(scene.opacity_logits),
        "sh": np.asarray(scene.sh),
        "alive": np.asarray(scene.alive),
    }
    meta = {"version": FORMAT_VERSION, "sh_deg": scene.sh_deg,
            "iteration": iteration, "extra": extra or {}}
    if opt_state is not None:
        arrays["adam_m_packed"] = np.asarray(opt_state.m)
        arrays["adam_v_packed"] = np.asarray(opt_state.v)
        meta["adam_iteration"] = int(opt_state.iteration)
    arrays["_meta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **arrays)


def load_checkpoint(path: str | os.PathLike):
    """Returns (scene, opt_state | None, meta)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta"]).decode("utf-8"))
        scene = GaussianScene(
            means=jnp.asarray(z["means"]),
            quats=jnp.asarray(z["quats"]),
            log_scales=jnp.asarray(z["log_scales"]),
            opacity_logits=jnp.asarray(z["opacity_logits"]),
            sh=jnp.asarray(z["sh"]),
            alive=jnp.asarray(z["alive"]),
            sh_deg=int(meta["sh_deg"]),
        )
        opt_state = None
        if "adam_m_packed" in z:
            opt_state = AdamState(
                m=jnp.asarray(z["adam_m_packed"]),
                v=jnp.asarray(z["adam_v_packed"]),
                iteration=jnp.int32(meta.get("adam_iteration", 0)),
            )
        elif "adam_m_means" in z:
            # version-1 checkpoints stored per-leaf moments; pack on load
            keys = ["means", "quats", "log_scales", "opacity_logits", "sh"]
            opt_state = AdamState(
                m=pack_rows({k: jnp.asarray(z[f"adam_m_{k}"])
                             for k in keys}),
                v=pack_rows({k: jnp.asarray(z[f"adam_v_{k}"])
                             for k in keys}),
                iteration=jnp.int32(meta.get("adam_iteration", 0)),
            )
    return scene, opt_state, meta
