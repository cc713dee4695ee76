"""Write ``tests/data/torch_ckpt/fixture_1024/``: the JAX package's
``save_bank`` of the fixture bank (``benchmarks/reference/out/features``,
1024 templates), an orbax checkpoint (OCDBT, zarr v2, zstd), which
``chip_smoke.py`` phase 7e loads on the card, where there is no orbax.

    python tests/make_torch_ckpt.py

Needs JAX and orbax (this writes with them).  Beside the checkpoint,
``digests.json`` holds each leaf's sha256 (of its C-order bytes), dtype
and shape as the JAX package's ``load_bank`` restores them.
``tests/test_torch_persist.py`` holds the committed checkpoint to JAX's
``load_bank`` and to these digests, so a change in orbax shows.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_ckpt", "fixture_1024")
YAML = os.path.join(REPO, "benchmarks", "reference", "out", "features",
                    "linemod_templates.yml")


def leaf_digests(bank) -> dict:
    """name -> {sha256, dtype, shape} of each array leaf of a bank (JAX's
    or, through ``.cpu()``, the port's)."""
    out = {}
    for name in ("feat_x", "feat_y", "feat_label", "feat_valid", "width",
                 "height", "offset_x", "offset_y", "pose", "class_idx",
                 "template_idx", "valid"):
        leaf = getattr(bank, name)
        arr = np.ascontiguousarray(
            leaf.cpu().numpy() if hasattr(leaf, "cpu") else np.asarray(leaf))
        out[name] = {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                     "dtype": str(arr.dtype), "shape": list(arr.shape)}
    return out


def main() -> None:
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from fealess_tpu.io import checkpoint

    bank, det = checkpoint.import_yaml(YAML)
    shutil.rmtree(OUT, ignore_errors=True)
    checkpoint.save_bank(OUT, bank, det)
    restored, _ = checkpoint.load_bank(OUT)
    digests = leaf_digests(restored)
    assert digests == leaf_digests(bank)
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(OUT) for f in fs)
    print(f"wrote {OUT} ({total} bytes)")


if __name__ == "__main__":
    main()
