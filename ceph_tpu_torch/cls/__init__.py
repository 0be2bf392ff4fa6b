"""Object classes: in-OSD stored procedures (reference:src/cls/).

The reference loads ``libcls_*.so`` plugins into the OSD; clients invoke
their methods atomically on one object via the ``call`` op
(reference:src/osd/PrimaryLogPG.cc do_osd_ops CEPH_OSD_OP_CALL →
ClassHandler, reference:src/osd/ClassHandler.cc).  A method declares
RD/WR flags; its reads see the object's current state and its writes
join the op's transaction, so the whole call commits atomically with
the rest of the client op.

Here a class is a registered Python module of methods over a
:class:`MethodContext` (the ``cls_method_context_t`` analog).  The
built-ins mirror the reference's most-used classes: ``lock``
(advisory object locks, reference:src/cls/lock/) and ``refcount``
(reference:src/cls/refcount/).

Counterpart of ``ceph_tpu/cls/__init__.py``, whole, with a registry of
its own: the built-ins register here, and an external class file under
``osd_class_dir`` (``cls_<name>.py``) registers through
``ceph_tpu_torch.cls``.  A file that registers its class anywhere else
is answered as loaded but never registered (``-EIO``).  The class state
a method writes (``c_``-prefixed xattrs, omap) is the reference's, so
either package's OSD reads what the other's wrote.
"""

from __future__ import annotations

import json
from typing import Callable

CLS_METHOD_RD = 1
CLS_METHOD_WR = 2

# errnos the methods use (match the OSD's convention)
EBUSY = 16
EEXIST = 17
ENOENT = 2
EINVAL = 22


class ClsError(Exception):
    """Method failure with an errno (negative return in the reference)."""

    def __init__(self, code: int, msg: str = ""):
        super().__init__(msg or f"cls error {code}")
        self.code = code


class MethodContext:
    """What a method may touch: ONE object, through the op's transaction
    (reference:cls_method_context_t / PrimaryLogPG::do_osd_op wrapper).

    Reads go to the store's current state; writes are recorded through
    the supplied callbacks so they join the surrounding transaction and
    commit (and replicate) atomically with it.
    """

    def __init__(
        self,
        *,
        read: Callable[[], bytes | None],
        getxattr: Callable[[str], bytes | None],
        setxattr: Callable[[str, bytes], None] | None = None,
        omap_get: Callable[[], dict[str, bytes]] | None = None,
        omap_get_keys: Callable[[list[str]], dict[str, bytes]] | None = None,
        omap_get_range: Callable[
            [str, str, int], tuple[dict[str, bytes], bool]
        ] | None = None,
        omap_set: Callable[[dict[str, bytes]], None] | None = None,
        omap_rm: Callable[[list[str]], None] | None = None,
        write_full: Callable[[bytes], None] | None = None,
        writable: bool = False,
    ):
        self._read = read
        self._getxattr = getxattr
        self._setxattr = setxattr
        self._omap_get = omap_get
        self._omap_get_keys = omap_get_keys
        self._omap_get_range = omap_get_range
        self._omap_set = omap_set
        self._omap_rm = omap_rm
        self._write_full = write_full
        self.writable = writable

    # -- reads
    def read(self) -> bytes | None:
        return self._read()

    def getxattr(self, key: str) -> bytes | None:
        return self._getxattr(key)

    def omap_get(self) -> dict[str, bytes]:
        return self._omap_get() if self._omap_get else {}

    def omap_get_keys(self, keys: list[str]) -> dict[str, bytes]:
        """Keyed lookup — O(len(keys)), not a full-index copy; hot-path
        methods (single-entry get/put/rm) must use this."""
        if self._omap_get_keys:
            return self._omap_get_keys(list(keys))
        omap = self.omap_get()
        return {k: omap[k] for k in keys if k in omap}

    def omap_get_range(
        self, *, start_after: str = "", prefix: str = "",
        max_entries: int = 1000,
    ) -> tuple[dict[str, bytes], bool]:
        """One sorted page strictly after ``start_after`` under
        ``prefix``: (page, truncated).  Pagers (rgw list) must use this
        instead of omap_get — a full-index copy per 1000-entry page
        turns listing into O(n^2/1000)."""
        if self._omap_get_range:
            return self._omap_get_range(start_after, prefix, max_entries)
        from ..store.objectstore import omap_range_page

        return omap_range_page(
            self.omap_get(), start_after, prefix, max_entries
        )

    # -- writes (WR methods only)
    def _need_wr(self) -> None:
        if not self.writable:
            raise ClsError(EINVAL, "write from a read-only method context")

    def setxattr(self, key: str, value: bytes) -> None:
        self._need_wr()
        self._setxattr(key, value)

    def omap_set(self, kv: dict[str, bytes]) -> None:
        self._need_wr()
        self._omap_set(kv)

    def omap_rm(self, keys: list[str]) -> None:
        self._need_wr()
        self._omap_rm(keys)

    def write_full(self, data: bytes) -> None:
        self._need_wr()
        self._write_full(data)

    # -- convenience for json-speaking methods
    def get_json(self, key: str) -> dict | None:
        raw = self.getxattr(key)
        return json.loads(raw) if raw else None

    def set_json(self, key: str, value: dict) -> None:
        self.setxattr(key, json.dumps(value).encode())


class ClassMethod:
    def __init__(self, name: str, flags: int, fn: Callable):
        self.name = name
        self.flags = flags
        self.fn = fn

    @property
    def is_write(self) -> bool:
        return bool(self.flags & CLS_METHOD_WR)


class ObjectClass:
    """One registered class (``cls_register`` analog)."""

    def __init__(self, name: str):
        self.name = name
        self.methods: dict[str, ClassMethod] = {}

    def method(self, name: str, flags: int):
        """Decorator: register a method (cls_register_cxx_method)."""

        def deco(fn):
            self.methods[name] = ClassMethod(name, flags, fn)
            return fn

        return deco


_classes: dict[str, ObjectClass] = {}


def register_class(name: str) -> ObjectClass:
    if name not in _classes:
        _classes[name] = ObjectClass(name)
    return _classes[name]


class ClsLoadError(Exception):
    """External class file exists but failed to load (the reference's
    dlopen/_cls_init failure path, reference:src/osd/ClassHandler.cc
    open_class -> -EIO)."""


def get_class(name: str, class_dir: str | None = None) -> ObjectClass | None:
    """Look up a class; on miss, try ``class_dir`` — the dlopen analog
    (reference:src/osd/ClassHandler.cc open_class loads
    ``$osd_class_dir/libcls_<name>.so``; here ``cls_<name>.py``).

    The external module registers itself via :func:`register_class` at
    import, exactly like the built-ins.  A broken file raises
    :class:`ClsLoadError` (the OSD answers the op with -EIO); a missing
    file is a plain miss (-EOPNOTSUPP), so a typo'd class name cannot
    be confused with a broken deployment."""
    _load_builtins()
    if name not in _classes and class_dir and _CLASS_NAME_RE.match(name):
        _load_external(name, class_dir)
    return _classes.get(name)


def list_classes() -> list[str]:
    _load_builtins()
    return sorted(_classes)


import re

# dlopen'd class names in the reference are library identifiers; keep
# the same shape so a hostile class name can't traverse paths
_CLASS_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")

# (name, dir) -> ClsLoadError for a broken file, None for loaded/missing;
# a broken class stays broken on every call (the reference caches the
# open_class status too) rather than decaying into a name miss
_external_status: dict[tuple[str, str], "ClsLoadError | None"] = {}


def _load_external(name: str, class_dir: str) -> None:
    import importlib.util
    import os

    key = (name, class_dir)
    if key in _external_status:
        err = _external_status[key]
        if err is not None:
            raise err
        return
    path = os.path.join(class_dir, f"cls_{name}.py")
    if not os.path.isfile(path):
        # NOT cached: a class file deployed after the first lookup must
        # take effect without an OSD restart
        return
    before = set(_classes)
    try:
        spec = importlib.util.spec_from_file_location(
            f"ceph_tpu_torch_external_cls_{name}", path
        )
        if spec is None or spec.loader is None:
            raise ClsLoadError(f"cannot load class file {path!r}")
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        except BaseException as e:
            # BaseException: a class file calling sys.exit() (or raising
            # anything else exotic) must become a cached -EIO with full
            # rollback, not kill the OSD or leave a half-registered
            # class served
            raise ClsLoadError(
                f"class {name!r} at {path!r} failed: {e!r}"
            ) from e
        if name not in _classes:
            raise ClsLoadError(
                f"class file {path!r} loaded but never registered {name!r}"
            )
    except BaseException as e:
        # roll back any classes the crashing file registered before it
        # died: a half-initialized class must answer -EIO on every call,
        # never serve its surviving half; cache EVERY failure as broken
        # so nothing decays into a name miss
        for added in set(_classes) - before:
            del _classes[added]
        err = (e if isinstance(e, ClsLoadError)
               else ClsLoadError(f"class {name!r} at {path!r}: {e!r}"))
        _external_status[key] = err
        raise err from (None if err is e else e)
    # success only: cached as loaded
    _external_status[key] = None


_loaded = False


def _load_builtins() -> None:
    """Import the built-in classes on first use (the OSD's cls preload,
    reference:src/osd/ClassHandler.cc open_all_classes)."""
    global _loaded
    if _loaded:
        return
    _loaded = True
    from . import (  # noqa: F401
        lock,
        log,
        numops,
        rbd_cls,
        refcount,
        rgw_index,
        version,
    )
