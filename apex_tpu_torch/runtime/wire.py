"""The allowlisted unpickler for bytes that cross a process boundary.

Counterpart of :mod:`apex_tpu.runtime.wire`.  The chunk plane's wire
format is pickle, and a bare ``pickle.loads`` runs whatever callable a
payload names.  :class:`RestrictedUnpickler` resolves only the globals the
port's messages need (numpy's array reconstruction and the actor pool's
stat classes); any other raises :class:`WireRejected` for the caller to
count and drop.  Chunk messages themselves are dicts, tuples and arrays,
which unpickle without naming a class.
"""

from __future__ import annotations

import io
import pickle


class WireRejected(pickle.UnpicklingError):
    """A payload referenced a global outside the wire allowlist."""


#: exact (module, name) pairs the port's messages resolve: the actor stat
#: dataclasses and numpy's reconstruction helpers (the numpy>=2 ``_core``
#: and numpy<2 ``core`` spellings both)
ALLOWED_GLOBALS: frozenset[tuple[str, str]] = frozenset({
    ("apex_tpu_torch.actors.pool", "EpisodeStat"),
    ("apex_tpu_torch.actors.pool", "ActorTimingStat"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy.core.numeric", "_frombuffer"),
})


class RestrictedUnpickler(pickle.Unpickler):
    """Unpickler whose global resolution is exactly :data:`ALLOWED_GLOBALS`."""

    def find_class(self, module: str, name: str):
        if (module, name) in ALLOWED_GLOBALS:
            return super().find_class(module, name)
        raise WireRejected(
            f"wire payload references {module}.{name}, which is outside "
            f"the apex_tpu_torch.runtime.wire allowlist")


def restricted_loads(data: bytes):
    """``pickle.loads`` with the wire allowlist; raises
    :class:`WireRejected` on any global outside it."""
    return RestrictedUnpickler(io.BytesIO(data)).load()
