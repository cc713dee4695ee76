from fealess_tpu_torch.parallel import (  # noqa: F401
    mesh, sharded_icp, sharded_match)

__all__ = ["mesh", "sharded_match", "sharded_icp"]
