"""The benchmark's own spans around the program's layers, for traced runs.

``torch.profiler.record_function`` ranges opened by forward hooks on a
module, or by a wrapper around a module-level function, named ``pb.<layer>``
and followed by the integers the layer's roofline needs
(``pb.cn:<rows>:<channels>:<gelu>:<itemsize>``). Everything installed here is
removed when the ``Spans`` context closes; no file of the program changes.
"""
from __future__ import annotations

import contextlib
import functools

from torch.profiler import record_function


def span_name(prefix: str, *ints) -> str:
    return ":".join([prefix, *(str(int(v)) for v in ints)])


class Spans(contextlib.ExitStack):
    """Hooks and wrappers installed for the life of the context."""

    def module(self, module, name_fn) -> None:
        """A span around every forward of ``module``;
        ``name_fn(module, args, kwargs)`` gives its name."""
        stack = []

        def pre(mod, args, kwargs):
            rf = record_function(name_fn(mod, args, kwargs))
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, kwargs, out):
            stack.pop().__exit__(None, None, None)

        handles = [module.register_forward_pre_hook(pre, with_kwargs=True),
                   module.register_forward_hook(post, with_kwargs=True)]
        self.callback(lambda: [h.remove() for h in handles])

    def modules(self, root, cls, name_fn) -> None:
        """A span around every forward of each ``cls`` module under ``root``."""
        for m in root.modules():
            if isinstance(m, cls):
                self.module(m, name_fn)

    def function(self, owner, attr: str, name_fn) -> None:
        """A span around every call of ``owner.attr`` (a module-level
        function that its callers look up by name)."""
        original = getattr(owner, attr)

        @functools.wraps(original)
        def wrapped(*args, **kwargs):
            with record_function(name_fn(*args, **kwargs)):
                return original(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self.callback(setattr, owner, attr, original)


def stats_name(feats0, feats1, cfg=None) -> str:
    """``pb.stats`` with n, h, w, c, itemsize of each stage's pair."""
    ints = []
    for f in feats0:
        ints += [*f.shape, f.element_size()]
    return span_name("pb.stats", *ints)
