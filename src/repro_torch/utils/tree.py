"""Small tree / numerics helpers on nested dicts, lists and tuples of
tensors (θ, optimizer states): the port of ``repro.utils.tree``."""
import torch


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        out = [_map(fn, *xs) for xs in zip(*trees)]
        return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
    return fn(*trees)


def _tensors(tree):
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


def tree_size(tree) -> int:
    return sum(x.numel() for x in _tensors(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _tensors(tree))


def tree_norm(tree) -> torch.Tensor:
    """The global L2 norm over every tensor leaf, in f32."""
    return torch.sqrt(sum(x.to(torch.float32).square().sum()
                          for x in _tensors(tree)))


def tree_add(a, b, scale_b=1.0):
    return _map(lambda x, y: x + scale_b * y, a, b)


def tree_scale(a, s):
    return _map(lambda x: s * x, a)


def tree_zeros_like(a):
    return _map(torch.zeros_like, a)


def has_nan(tree) -> bool:
    """True when any tensor leaf holds a NaN or an infinity."""
    return any(bool((~torch.isfinite(x.to(torch.float32))).any())
               for x in _tensors(tree))
