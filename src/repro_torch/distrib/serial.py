"""Function/closure serialization for cross-process task shipment.

``pickle`` refuses locally-defined functions and closures — exactly what
the generated ``__pfor_body_N`` chunk functions are. This module encodes a
function as:

  * its code object (``marshal`` — same interpreter on both ends, which
    the spawned-worker model guarantees);
  * its closure cell values (pickled — this is how the captured kernel
    arrays travel to the worker);
  * the globals it references, each as a module-by-name marker (``xp`` →
    re-import ``numpy`` on the worker), a pickled value, or the
    ``__pfor_run`` sentinel (a nested pfor inside a shipped chunk runs
    sequentially on the worker — one level of distribution is enough);
  * name / defaults.

Everything lands in one ``bytes`` blob; :func:`loads_fn` rebuilds a real
function with fresh cells on the receiving process.

For pfor bodies the monolithic blob is additionally *split*
(:func:`split_fn`) into a content-hashed skeleton, individually hashed
broadcast cells, and live sliceable arrays whose chunk rows ship per
task — the decomposition behind the cluster's persistent blob cache and
chunk-sliced argument shipping (:class:`ClosureParts`,
:class:`ChunkSlice`).
"""

from __future__ import annotations

import hashlib
import importlib
import marshal
import pickle
import types
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

_PICKLE_PROTO = 4

# Global-slot markers
_MOD = "mod"        # re-import module by name
_VAL = "val"        # pickled value
_PFOR = "pfor"      # substitute the worker's sequential __pfor_run
_SKIP = "skip"      # unpicklable and unknown: leave unbound


def _sequential_pfor_run(body, lo, hi, tile):
    """Worker-side stand-in for nested pfor hooks: run the chunk inline
    (the head already sharded the outermost level across processes)."""
    if hi > lo:
        body(lo, hi)


def _referenced_globals(code) -> List[str]:
    """All global names a code object (or its nested code consts) loads."""
    names = list(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names.extend(_referenced_globals(const))
    seen, out = set(), []
    for n in names:
        if n not in seen:
            seen.add(n)
            out.append(n)
    return out


def _skeleton_dict(fn) -> Dict[str, Any]:
    """Everything shippable about a function *except* its cell values:
    code, free-var order, resolved globals, name, defaults."""
    code = fn.__code__
    gslots: Dict[str, Tuple[str, Any]] = {}
    for name in _referenced_globals(code):
        if name not in fn.__globals__:
            continue
        val = fn.__globals__[name]
        if name == "__pfor_run":
            gslots[name] = (_PFOR, None)
        elif isinstance(val, types.ModuleType):
            gslots[name] = (_MOD, val.__name__)
        else:
            try:
                gslots[name] = (_VAL, pickle.dumps(
                    val, protocol=_PICKLE_PROTO))
            except Exception:
                gslots[name] = (_SKIP, None)
    return {
        "code": marshal.dumps(code),
        "freevars": code.co_freevars,
        "globals": gslots,
        "name": fn.__name__,
        "defaults": pickle.dumps(fn.__defaults__, protocol=_PICKLE_PROTO),
        "kwdefaults": pickle.dumps(fn.__kwdefaults__,
                                   protocol=_PICKLE_PROTO),
    }


def _build_globals(payload: Dict[str, Any]) -> Dict[str, Any]:
    g: Dict[str, Any] = {"__builtins__": __builtins__}
    for name, (kind, data) in payload["globals"].items():
        if kind == _MOD:
            # ``__cuk`` (repro_torch.kernels.api) travels this way too:
            # the worker imports it by name, bound to its own device
            g[name] = importlib.import_module(data)
        elif kind == _VAL:
            g[name] = pickle.loads(data)
        elif kind == _PFOR:
            g[name] = _sequential_pfor_run
        # _SKIP: unbound — a NameError on use is the honest failure mode
    return g


def _make_fn(payload: Dict[str, Any], cells: Tuple) -> types.FunctionType:
    code = marshal.loads(payload["code"])
    fn = types.FunctionType(code, _build_globals(payload),
                            payload["name"],
                            pickle.loads(payload["defaults"]), cells)
    kwdefaults = payload.get("kwdefaults")
    if kwdefaults is not None:
        fn.__kwdefaults__ = pickle.loads(kwdefaults)
    return fn


def dumps_fn(fn) -> bytes:
    """Encode a function — closures included — into a shippable blob."""
    payload = _skeleton_dict(fn)
    payload["cells"] = [pickle.dumps(cell.cell_contents,
                                     protocol=_PICKLE_PROTO)
                        for cell in (fn.__closure__ or ())]
    return pickle.dumps(payload, protocol=_PICKLE_PROTO)


def loads_fn(blob: bytes):
    """Rebuild a function serialized by :func:`dumps_fn`.

    The result carries fresh closure cells holding the *worker's* copies
    of the captured objects; ``fn.__closure__`` is the worker-side handle
    used to read arrays back out after a chunk runs."""
    payload = pickle.loads(blob)
    cells = tuple(types.CellType(pickle.loads(c))
                  for c in payload["cells"])
    return _make_fn(payload, cells)


# ---------------------------------------------------------------------------
# Chunk-sliced shipment (the data-movement layer)
# ---------------------------------------------------------------------------

class ChunkSlice(np.ndarray):
    """Rows ``[base, base+n)`` of a larger array, indexed with *global*
    leading-axis coordinates.

    A pfor chunk body generated for iterations ``[lo, hi)`` indexes its
    sliceable arrays as ``arr[v, ...]`` with ``v`` in the global range;
    the worker only holds the shipped rows, so the leading index is
    re-based by ``-base`` on the way in. Derived views and arithmetic
    results reset ``base`` to 0 (``__array_finalize__``), so only the
    explicitly wrapped top-level cell re-bases. Out-of-chunk accesses
    raise rather than wrap around — the sliceability analysis proves they
    cannot happen, so one firing means a miscompile, not silent
    corruption."""

    _chunk_base = 0

    def __array_finalize__(self, obj):
        self._chunk_base = 0

    def _rebase(self, key):
        base = self._chunk_base
        if not base:
            return key
        if isinstance(key, tuple):
            return (self._rebase0(key[0], base),) + key[1:]
        return self._rebase0(key, base)

    @staticmethod
    def _rebase0(k, base):
        if isinstance(k, (int, np.integer)):
            j = int(k) - base
            if j < 0:
                raise IndexError(
                    f"chunk-sliced access to row {int(k)} below chunk "
                    f"base {base} (sliceability misclassification?)")
            return j
        if isinstance(k, slice):
            lo = None if k.start is None else k.start - base
            hi = None if k.stop is None else k.stop - base
            if (lo is not None and lo < 0) or (hi is not None and hi < 0):
                raise IndexError(
                    f"chunk-sliced access {k} below chunk base {base}")
            return slice(lo, hi, k.step)
        raise IndexError(
            f"chunk-sliced array indexed by {type(k).__name__} on the "
            f"leading axis (only the pfor iterator is provably in-chunk)")

    # both accessors go through a base-class view: ndarray.__setitem__
    # on a subclass re-enters the Python-level __getitem__ with the
    # already-rebased key (numpy's subview assignment path), which would
    # rebase twice. The plain view also means directly indexed results
    # are ordinary ndarrays — only the top-level cell re-bases.
    def __getitem__(self, key):
        return self.view(np.ndarray)[self._rebase(key)]

    def __setitem__(self, key, value):
        self.view(np.ndarray)[self._rebase(key)] = value


def rebase_chunk(arr: np.ndarray, base: int) -> ChunkSlice:
    """Wrap a shipped chunk so global leading-axis indices resolve."""
    view = arr.view(ChunkSlice)
    view._chunk_base = int(base)
    return view


def _hash(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# skeleton bytes/hash per code object: a serving loop re-creates the
# same pfor body closure every call, and re-pickling the (identical)
# skeleton per dispatch is pure hot-path waste. Only cacheable when the
# skeleton is a pure function of the code object — no pickled-value
# globals and no defaults, which generated pfor bodies satisfy (their
# globals are module markers and the __pfor_run sentinel).
_SKELETON_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _skeleton_for(fn) -> Tuple[bytes, str]:
    code = fn.__code__
    hit = _SKELETON_CACHE.get(code)
    if hit is not None:
        return hit
    d = _skeleton_dict(fn)
    blob = pickle.dumps(d, protocol=_PICKLE_PROTO)
    h = _hash(blob)
    if (fn.__defaults__ is None and fn.__kwdefaults__ is None
            and all(kind != _VAL for kind, _ in d["globals"].values())):
        _SKELETON_CACHE[code] = (blob, h)
    return blob, h


@dataclass
class ClosureParts:
    """A pfor body decomposed for slice-aware, cache-aware shipment.

    ``skeleton`` (code + globals + defaults, no cell values) broadcasts
    once per worker and is content-addressed by ``code_hash``;
    ``cell_pkls`` are the broadcast cells, individually pickled and
    hashed so a serving loop re-ships only the ones that changed;
    ``sliced`` keeps live references to the sliceable arrays — each chunk
    task ships just its ``[lo, hi)`` rows of them. ``backend`` tags which
    body variant the skeleton encodes ("np" or "cuda"); backend twins of
    the same pfor close over the same cells, so
    :func:`split_fn_variants` builds their parts sharing one
    content-addressed cell store (each cell pickled and hashed once)."""

    skeleton: bytes
    code_hash: str
    struct_sig: str
    cell_pkls: Dict[str, bytes] = field(default_factory=dict)
    cell_hashes: Dict[str, str] = field(default_factory=dict)
    sliced: Dict[str, np.ndarray] = field(default_factory=dict)
    backend: str = "np"

    @property
    def blob_key(self) -> Tuple[str, str]:
        return (self.code_hash, self.struct_sig)

    def broadcast_nbytes(self) -> int:
        return len(self.skeleton) + sum(
            len(b) for b in self.cell_pkls.values())


def split_fn(fn, sliceable: Sequence[str] = (),
             backend: str = "np",
             _cell_memo: Dict[int, Tuple[bytes, str]] = None
             ) -> ClosureParts:
    """Decompose a closure into skeleton + per-cell payloads.

    Cells named in ``sliceable`` that hold ndarrays stay live (shipped
    per chunk as row slices); every other cell is pickled and
    content-hashed for the changed-cells-only re-ship protocol.
    ``_cell_memo`` (id(value) → (pickle, hash)) lets backend twins of
    one body share the pickling work — see :func:`split_fn_variants`."""
    skeleton, code_hash = _skeleton_for(fn)
    sliceable = set(sliceable)
    memo = _cell_memo if _cell_memo is not None else {}
    sig_parts: List[str] = []
    cell_pkls: Dict[str, bytes] = {}
    cell_hashes: Dict[str, str] = {}
    sliced: Dict[str, np.ndarray] = {}

    def pickled(val) -> Tuple[bytes, str]:
        hit = memo.get(id(val))
        if hit is None:
            pkl = pickle.dumps(val, protocol=_PICKLE_PROTO)
            hit = (pkl, _hash(pkl))
            memo[id(val)] = hit
        return hit

    for name, val in closure_arrays(fn).items():
        if (name in sliceable and isinstance(val, np.ndarray)
                and val.ndim >= 1):
            sliced[name] = val
            sig_parts.append(f"{name}:S{val.shape}:{val.dtype}")
        elif isinstance(val, np.ndarray):
            cell_pkls[name], cell_hashes[name] = pickled(val)
            sig_parts.append(f"{name}:B{val.shape}:{val.dtype}")
        else:
            cell_pkls[name], cell_hashes[name] = pickled(val)
            sig_parts.append(f"{name}:v{type(val).__name__}")
    return ClosureParts(skeleton=skeleton, code_hash=code_hash,
                        struct_sig=";".join(sig_parts),
                        cell_pkls=cell_pkls, cell_hashes=cell_hashes,
                        sliced=sliced, backend=backend)


def split_fn_variants(bodies: Dict[str, Any],
                      sliceable: Sequence[str] = ()
                      ) -> Dict[str, ClosureParts]:
    """Backend → ClosureParts for the variant bodies of one pfor.

    Backend names must be registered (:mod:`repro_torch.core.backends`) — the
    bodies dict is keyed by codegen's ``__backend__`` stamps, which the
    registry produced, so an unknown key here means a mismatched or
    hand-rolled body and is worth failing loudly over.

    Twin bodies are closures over the *same* enclosing scope, so their
    cells hold identical objects — each value is pickled and hashed once
    and the resulting content-addressed entries are shared across the
    per-backend parts (persistent-blob reuse survives backend tagging)."""
    from repro_torch.core import backends as _backends

    unknown = [bk for bk in bodies if not _backends.is_registered(bk)]
    if unknown:
        raise ValueError(
            f"unregistered backend name(s) {unknown} in variant bodies "
            f"(registered: {_backends.names()})")
    memo: Dict[int, Tuple[bytes, str]] = {}
    return {bk: split_fn(fn, sliceable, backend=bk, _cell_memo=memo)
            for bk, fn in bodies.items()}


def assemble_fn(skeleton: bytes, cell_values: Dict[str, Any]):
    """Worker-side: rebuild a function from a shipped skeleton plus cell
    values by name. Names absent from ``cell_values`` (the sliced arrays,
    delivered per chunk) get empty cells to be filled before each run.

    Returns ``(fn, cellmap)`` where ``cellmap`` maps free-var name → cell
    object, the mutation handle for changed-cell updates and per-chunk
    slice installation."""
    payload = pickle.loads(skeleton)
    cellmap: Dict[str, Any] = {}
    cells = []
    for name in payload["freevars"]:
        cell = (types.CellType(cell_values[name])
                if name in cell_values else types.CellType())
        cellmap[name] = cell
        cells.append(cell)
    return _make_fn(payload, tuple(cells)), cellmap


def payload_split_nbytes(fn, sliceable: Sequence[str] = ()
                         ) -> Tuple[int, int]:
    """(broadcast_bytes, sliced_bytes) of a closure's captured ndarrays.

    Broadcast arrays ship once *per worker*; sliced arrays ship once
    *total* (each worker gets its rows) — the cost model weighs them
    accordingly."""
    sliceable = set(sliceable)
    bcast = sliced = 0
    for name, v in closure_arrays(fn).items():
        nb = getattr(v, "nbytes", None)
        if nb is None:
            continue
        if name in sliceable and getattr(v, "ndim", 0) >= 1:
            sliced += int(nb)
        else:
            bcast += int(nb)
    return bcast, sliced


def closure_arrays(fn) -> Dict[str, Any]:
    """Name → value for every closure cell of ``fn`` (by free-var name)."""
    out: Dict[str, Any] = {}
    for name, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
        out[name] = cell.cell_contents
    return out


