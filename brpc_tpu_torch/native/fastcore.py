"""Loader of the ``_brpc_fastcore`` CPython extension (the port of
brpc_tpu/native/fastcore.py).

``get()`` returns the extension module, building it at the first call,
or None: ``BRPC_TPU_TORCH_NO_NATIVE`` is set, or the build or the load
failed (``load_error`` says why). Every consumer keeps its pure-Python
lane. The extension puts the native cores on the per-call path:
``pack_frame``/``pack_frame_head``/``parse_head`` (tpu_std framing),
``scan_frames`` (the turbo lane), ``serve_scan``/``serve_drain`` (the
echo loops), ``pluck_scan`` (the sync pluck lane), ``http_parse_request``,
``Pool`` (versioned ids), ``Mpsc`` (the socket write queue) and
``syscall_counts``. Under a sanitize mode it latches as ``lib()`` does
(``brpc_tpu_torch/native/__init__.py``): it loads the ``.san`` output or
raises, on every call, and never falls back.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import sys
import threading
from typing import Optional

from . import SANITIZE_ENV, native_disabled

log = logging.getLogger("brpc_tpu_torch.native")

_lock = threading.Lock()
_mod = None
_tried = False
load_error: Optional[str] = None
# BRPC_TPU_TORCH_SANITIZE as the loader latched it
_latched_san: Optional[str] = None


def get():
    global _mod, _tried, load_error, _latched_san
    if _tried:
        if os.environ.get(SANITIZE_ENV, "") != _latched_san:
            from .build import sanitize_changed_error
            raise sanitize_changed_error(_latched_san)
        return _mod
    with _lock:
        if _tried:
            return _mod
        from .build import (build_fastcore, check_no_native_conflict,
                            sanitize_mode, sanitized_load_failure)
        san = sanitize_mode()
        if native_disabled():
            check_no_native_conflict(san)
        else:
            try:
                path = build_fastcore()
                spec = importlib.util.spec_from_file_location(
                    "_brpc_fastcore", str(path))
                # brpc_tpu's extension has the same name: the port's
                # must not take its place in sys.modules
                prev = sys.modules.get("_brpc_fastcore")
                try:
                    mod = importlib.util.module_from_spec(spec)
                    spec.loader.exec_module(mod)
                finally:
                    if prev is None:
                        sys.modules.pop("_brpc_fastcore", None)
                    else:
                        sys.modules["_brpc_fastcore"] = prev
                _mod = mod
            except Exception as e:      # no compiler, no Python.h
                if san:
                    raise sanitized_load_failure(
                        san, "fastcore extension") from e
                load_error = f"{type(e).__name__}: {e}"
                log.warning("fastcore extension unavailable: %s",
                            load_error)
        _latched_san = os.environ.get(SANITIZE_ENV, "")
        _tried = True
    return _mod


def available() -> bool:
    return get() is not None


def _postfork_reset() -> None:
    """A forked child keeps the loaded module; only the latch lock must
    be fresh."""
    global _lock
    _lock = threading.Lock()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("native.fastcore", _postfork_reset)
