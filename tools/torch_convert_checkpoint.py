#!/usr/bin/env python3
"""Convert a JAX package checkpoint (an orbax directory written by
``tensorhive_tpu.train.save_checkpoint``: ``{"params", "opt_state"}``)
into the PyTorch port's layout: ``OUT_DIR/step_<n>.pt`` as
``tensorhive_tpu_torch.train.save_checkpoint`` writes it, which the port's
``GenerationService`` serves through ``GenerationConfig.checkpoint_path``
and ``train.restore_checkpoint`` resumes.

    python tools/torch_convert_checkpoint.py ORBAX_DIR OUT_DIR --preset 7b

Params and the Adam moments are carried across with the port's
``convert.params_from_jax`` as f32 (training's masters; serving casts them
to the preset's dtype when it loads them), the step and Adam's count as
integers. Runs on the CPU where JAX and orbax are installed; the port
itself imports neither.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def _find_adam_state(node: Any) -> Optional[Dict[str, Any]]:
    """The ``{"count", "mu", "nu"}`` node of a restored optax chain state
    (clip_by_global_norm, then adamw)."""
    if isinstance(node, dict):
        if {"count", "mu", "nu"} <= set(node):
            return node
        children = node.values()
    elif isinstance(node, (list, tuple)):
        children = node
    else:
        return None
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {key: _to_numpy(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(value) for value in tree]
    return np.asarray(tree)


def convert(orbax_dir: str, out_dir: str, preset: str) -> int:
    """Convert the newest step under ``orbax_dir``; returns the step."""
    import orbax.checkpoint as ocp
    import torch

    sys.path.insert(0, str(REPO))
    from tensorhive_tpu_torch import train
    from tensorhive_tpu_torch.convert import params_from_jax
    from tensorhive_tpu_torch.models.transformer import PRESETS

    with ocp.CheckpointManager(str(Path(orbax_dir).resolve())) as manager:
        step = manager.latest_step()
        if step is None:
            raise SystemExit(f"no checkpoint steps under {orbax_dir}")
        restored = manager.restore(step, args=ocp.args.PyTreeRestore())
    config = PRESETS[preset]
    params = params_from_jax(_to_numpy(restored["params"]), config, "cpu",
                             param_dtype=torch.float32)
    adam = _find_adam_state(restored["opt_state"])
    if adam is None:
        raise SystemExit(f"{orbax_dir}: no Adam state (count, mu, nu) in "
                         "opt_state — not a train_loop checkpoint?")
    opt_state = {
        "count": int(np.asarray(adam["count"])),
        "mu": params_from_jax(_to_numpy(adam["mu"]), config, "cpu",
                              param_dtype=torch.float32),
        "nu": params_from_jax(_to_numpy(adam["nu"]), config, "cpu",
                              param_dtype=torch.float32),
    }
    train.save_checkpoint(out_dir, int(step), params, opt_state)
    return int(step)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("orbax_dir")
    parser.add_argument("out_dir")
    parser.add_argument("--preset", required=True,
                        help="the model preset the checkpoint was trained as")
    args = parser.parse_args(argv)
    step = convert(args.orbax_dir, args.out_dir, args.preset)
    print(f"step {step}: {args.orbax_dir} -> {args.out_dir}/"
          f"step_{step:010d}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
