"""Migrate legacy pickle checkpoints to the durable npz format.

Port of the JAX system's ``scripts/migrate_checkpoints.py``: rewrites every
``*.ckpt`` under the given roots (default: ``artifacts``) that is still a
pre-npz pickle into the npz+JSON format of ``core/checkpoint.py``, which
both packages read. Idempotent: npz files are skipped. Values round-trip
exactly (arrays bit-identical, strings by value); a verification re-load
compares every leaf before the original is replaced.

Stricter than the JAX script, which unpickles everything: the port reads a
legacy pickle through its restricted unpickler (containers, Python and
numpy scalars, numpy arrays), so a file that names any other global (a
jax, flax or optax class, a callable of the file's choosing) is reported as
``refused <path>: <reason>`` and left untouched; the walk goes on, and the
script exits 1 when anything was refused.

    python -m camouflage_multimodal_tpu_torch.scripts.migrate_checkpoints [root ...]
"""

from __future__ import annotations

import os
import sys
from typing import Any, Iterator, Optional, Sequence, Tuple

import numpy as np

from camouflage_multimodal_tpu_torch.core.checkpoint import (
    checkpoint_format, load_checkpoint, save_checkpoint)


def _leaves(obj: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of a nested checkpoint, namedtuples by field name as the
    JAX script walks them."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for k in obj._fields:
            yield from _leaves(getattr(obj, k), path + (k,))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, obj


def migrate(path: str) -> bool:
    """Rewrite ``path`` as npz if it is a legacy pickle; False for an npz
    file. Raises ``ValueError`` (file untouched) when the restricted
    unpickler refuses it."""
    if checkpoint_format(path) == "npz":
        return False
    blob = load_checkpoint(path)
    save_checkpoint(path + ".new", blob)
    back = load_checkpoint(path + ".new")
    old = dict(_leaves(blob))
    new = dict(_leaves(back))
    if set(old) != set(new):
        raise RuntimeError(f"{path}: leaves differ after the round trip: "
                           f"{sorted(set(old) ^ set(new))}")
    for p, v in old.items():
        a, b = np.asarray(v), np.asarray(new[p])
        if a.dtype.kind in "OUS":
            if str(a) != str(b):
                raise RuntimeError(f"{path} {p}: {a!r} came back as {b!r}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{path} {p}")
    os.replace(path + ".new", path)
    return True


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Walk the roots; returns the exit code (1 when a file was refused)."""
    roots = list(sys.argv[1:] if argv is None else argv) or ["artifacts"]
    migrated = refused = 0
    for root in roots:
        for dirpath, _, files in os.walk(root):
            for f in sorted(files):
                if not f.endswith(".ckpt"):
                    continue
                full = os.path.join(dirpath, f)
                try:
                    done = migrate(full)
                except ValueError as e:   # the reason names the file first
                    print(f"refused {full}: {str(e).removeprefix(full + ': ')}", flush=True)
                    refused += 1
                    continue
                if done:
                    print("migrated", full, flush=True)
                    migrated += 1
                else:
                    print("already npz", full, flush=True)
    print(f"{migrated} checkpoint(s) migrated", flush=True)
    if refused:
        print(f"{refused} checkpoint(s) refused", flush=True)
    return 1 if refused else 0


if __name__ == "__main__":
    sys.exit(main())
