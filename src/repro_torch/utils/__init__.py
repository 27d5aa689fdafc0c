"""Process-level helpers: bounded caches and device placement; the tree
helpers (``tree``), re-exported as the reference's ``repro.utils``
does."""
from repro_torch.utils.tree import (has_nan, tree_add, tree_bytes,  # noqa: F401
                                    tree_norm, tree_scale, tree_size,
                                    tree_zeros_like)

__all__ = ["tree_size", "tree_bytes", "tree_norm", "tree_add", "tree_scale",
           "tree_zeros_like", "has_nan"]
