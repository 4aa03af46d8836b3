"""The incident manager (the port of brpc_tpu/incident/manager.py): the
glue between the anomaly watchdog and the traffic recorder, and the
keeper of the bounded artifact store.

  1. ``bvar/anomaly.py`` hands every tick's opened and closed incidents
     to ``incident_sample_tick``; idle, that costs one attribute read.
  2. An opening incident arms a capture window: the recorder records
     every request (rate 1.0, no budget) into a spool directory of the
     incident's (``Recorder.begin_incident_capture``, which keeps the
     session it found to give back).
  3. The window closes when the incident does or after
     ``incident_window_ticks`` ticks, whichever is first. Sealing starts
     the bundler thread (``incident_bundler``).
  4. The bundler gives the recorder back, reads the spool, and writes
     one size-capped ``.brpcinc`` artifact: the incident document, the
     /status, /timeline (the trigger keys), /hotspots, /device,
     /backends and /serving snapshots, the annotated rpcz spans and the
     window's requests. The spool is deleted and ``incident_disk_budget_
     mb`` evicts the oldest artifacts first.

The snapshot builders are bound on the caller's thread by
``bind_incident_imports`` (from ``anomaly.bind_watchdog_imports``, at
``Server.start``), never imported on the sampler or bundler thread.
``_lock`` is a leaf: it guards the window and the ledger; the recorder,
the disk and the snapshots are touched outside it. ``incident/
replay.py`` replays an artifact against a fresh server.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
import weakref
from typing import List

from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.bvar.reducer import Adder, PassiveStatus
from brpc_tpu_torch.incident.artifact import (SUFFIX, ArtifactWriter,
                                        artifact_files, artifact_summary)
from brpc_tpu_torch.rpc.errno_codes import errno_name
from brpc_tpu_torch.traffic import capture as _capture
from brpc_tpu_torch.traffic.corpus import read_corpus

# the environment may disarm it for a process (runs that compare arming
# off and on without touching flags)
define_flag("incident_capture_enabled",
            os.environ.get("BRPC_TPU_TORCH_INCIDENT_ARM", "1") != "0",
            "arm capture-on-anomaly: an opening watchdog incident "
            "flips the traffic recorder into corpus-recording mode "
            "for a bounded window and bundles an incident artifact")
define_flag("incident_dir", "",
            "directory for incident artifacts and capture spools "
            "(empty = incident capture off even when armed)")
define_flag("incident_window_ticks", 8,
            "sampler ticks an incident capture window stays open when "
            "the incident itself does not close first",
            validator=lambda v: v >= 1)
define_flag("incident_max_artifact_mb", 16,
            "size cap for one incident artifact (corpus records stop "
            "appending at the cap; the incident document and "
            "snapshots always fit first)",
            validator=lambda v: v >= 1)
define_flag("incident_disk_budget_mb", 64,
            "delete oldest incident artifacts past this total",
            validator=lambda v: v >= 1)
define_flag("incident_max_corpus_records", 8192,
            "in-window captured requests bundled into one artifact "
            "(oldest kept — the requests that led INTO the break)",
            validator=lambda v: v >= 1)

# collaborators bound on the caller thread (bind_incident_imports);
# never imported on the sampler tick or the bundler thread
_services_mod = None       # builtin.services (status/timeline builders)
_fr_mod = None             # builtin.flight_recorder
_span_mod = None           # rpc.span
_device_mod = None         # transport.device_stats
_backend_mod = None        # rpc.backend_stats

_SPAN_BUNDLE_MAX = 32


def bind_incident_imports() -> None:
    """One-time import binding for the bundler's snapshot builders;
    runs on the thread that starts the serving stack (Server.start →
    ensure_series → bind_watchdog_imports → here)."""
    global _services_mod, _fr_mod, _span_mod, _device_mod, _backend_mod
    if _services_mod is not None:
        return
    from brpc_tpu_torch.builtin import flight_recorder as fr
    from brpc_tpu_torch.builtin import services as sv
    from brpc_tpu_torch.rpc import backend_stats as bs
    from brpc_tpu_torch.rpc import span as sm
    from brpc_tpu_torch.transport import device_stats as ds
    _fr_mod, _span_mod, _device_mod, _backend_mod = fr, sm, ds, bs
    _services_mod = sv


class IncidentManager:
    """One instance per process (global_manager()). ``_lock`` is a
    LEAF guarding window state and the artifact ledger; everything
    that can block (recorder control, disk, snapshot builders) runs
    outside it."""

    def __init__(self):
        self._lock = threading.Lock()
        # sampler-tick hot flag: True while a window is armed OR a
        # seal is pending — the ONLY state incident_sample_tick reads
        # before early-outing on a calm tick
        self.window_engaged = False
        self._window_left = 0
        self._incident = None            # the watchdog's Incident object
        self._spool_dir = ""
        self._capture_flipped = False
        self._bundling = False
        self._server_ref = None          # weakref to the serving Server
        # artifact ledger (rebuilt lazily from disk on first read)
        self._artifacts: List[dict] = []
        self._artifact_bytes = 0
        self._scanned_dir = ""
        # lifetime counters (bvars read passively; survive unexpose)
        self.bundled = 0
        self.evicted = 0
        self.skipped = 0                 # open while busy/disabled
        self.last_error = ""

    # ------------------------------------------------------- tick path
    def incident_window_pass(self, opened, closed, t: int) -> None:
        """One tick's incident-window bookkeeping. Runs on the sampler
        thread after the watchdog's lock is released;
        rare by construction (incidents, not requests)."""
        arm = None
        seal = None
        with self._lock:
            if self.window_engaged and self._window_left > 0:
                self._window_left -= 1
                inc = self._incident
                if self._window_left <= 0 or (
                        closed is not None and closed is inc):
                    self._window_left = 0
                    if not self._bundling:
                        self._bundling = True
                        seal = inc
            if opened is not None and not self.window_engaged \
                    and not self._bundling:
                if flag("incident_capture_enabled") \
                        and flag("incident_dir"):
                    self.window_engaged = True
                    self._window_left = max(
                        1, int(flag("incident_window_ticks")))
                    self._incident = opened
                    arm = opened
                else:
                    self.skipped += 1
        if arm is not None:
            self._arm_capture_window(arm)
        if seal is not None:
            th = threading.Thread(
                target=self._bundle_worker, args=(seal,),
                name="incident_bundler", daemon=True)
            th.start()

    def _arm_capture_window(self, inc) -> None:
        """Flip the recorder into corpus-recording mode, spooling into
        a per-incident dir. Sampler thread, outside every lock of
        ours; module-level imports only (sampler-no-lazy-import)."""
        base = str(flag("incident_dir"))
        spool = os.path.join(
            base, f"spool-{inc.id}-{os.getpid()}")
        cfg = _capture.CaptureConfig(
            dir=spool, default_rate=1.0, max_per_second=0,
            rotate_bytes=int(flag("incident_max_artifact_mb")) << 20,
            disk_budget_bytes=int(
                flag("incident_disk_budget_mb")) << 20)
        ok = False
        try:
            ok = _capture.global_recorder().begin_incident_capture(cfg)
        except Exception:
            ok = False
        with self._lock:
            self._spool_dir = spool
            self._capture_flipped = ok

    # --------------------------------------------------- bundler thread
    def _bundle_worker(self, inc) -> None:
        """Everything disk: restore the recorder, read the spool,
        write the artifact, enforce the budget. Own thread — never the
        sampler, never dispatch."""
        try:
            self._bundle_incident(inc)
        except Exception as e:            # never take serving down
            self.last_error = f"{type(e).__name__}: {e}"
        finally:
            with self._lock:
                self._bundling = False
                self.window_engaged = False
                self._incident = None
                self._spool_dir = ""
                self._capture_flipped = False

    def _bundle_incident(self, inc) -> None:
        with self._lock:
            spool = self._spool_dir
            flipped = self._capture_flipped
        if flipped:
            _capture.global_recorder().end_incident_capture(flush_s=3.0)
        base = str(flag("incident_dir"))
        if not base:
            return
        records = []
        if spool and os.path.isdir(spool):
            try:
                records = read_corpus(spool)
            except OSError:
                records = []
        cap_bytes = int(flag("incident_max_artifact_mb")) << 20
        max_records = int(flag("incident_max_corpus_records"))
        doc = self._incident_document(inc, records)
        path = os.path.join(base, f"incident-{inc.id}-{os.getpid()}"
                                  f"-{int(time.time())}{SUFFIX}")
        os.makedirs(base, exist_ok=True)
        w = ArtifactWriter(path)
        truncated = 0
        try:
            w.put_incident_meta(doc)
            for name, snap in self._collect_snapshots(inc):
                if snap is None:
                    continue
                try:
                    w.put_snapshot(name, snap)
                except (TypeError, ValueError, OSError):
                    pass
            for i, rec in enumerate(records):
                if i >= max_records or w.bytes >= cap_bytes:
                    truncated = len(records) - i
                    break
                w.put_request(rec)
        finally:
            w.close()
        if truncated:
            # the sidecar records the truth; re-stamp the meta doc via
            # sidecar only (rewriting the recordio meta record would
            # mean rebuilding the file)
            try:
                with open(path + ".idx", encoding="utf-8") as f:
                    idx = json.load(f)
                idx["corpus_truncated"] = truncated
                with open(path + ".idx", "w", encoding="utf-8") as f:
                    json.dump(idx, f)
            except (OSError, ValueError):
                pass
        if spool:
            shutil.rmtree(spool, ignore_errors=True)
        self._enforce_disk_budget(base, keep=path)
        with self._lock:
            self.bundled += 1
            self._refresh_ledger_locked(base)   # bundler thread: disk ok
        nbundled.add(1)

    def _incident_document(self, inc, records) -> dict:
        classes = {}
        for rec in records:
            if rec.status:
                name = errno_name(rec.status)
                classes[name] = classes.get(name, 0) + 1
        d = inc.to_dict()
        d.update({
            "v": 1, "pid": os.getpid(),
            "created_wall": time.time(),
            "window_ticks": int(flag("incident_window_ticks")),
            "error_classes": classes,
            "corpus_records_total": len(records),
        })
        return d

    def _collect_snapshots(self, inc):
        """Yield (name, payload) pairs, each builder best-effort — a
        broken snapshot must not cost the artifact."""
        sv, fr, sm = _services_mod, _fr_mod, _span_mod
        ds, bs = _device_mod, _backend_mod
        server = self._server_ref() if self._server_ref else None
        if sv is not None and server is not None:
            try:
                yield "status", sv.status_page(server)
            except Exception:
                yield "status", None
        if sv is not None:
            try:
                names = list(inc.keys) or None
                yield "timeline", sv.timeline_page_payload(
                    None, names=names)
            except Exception:
                yield "timeline", None
        if fr is not None:
            try:
                yield "hotspots", fr.global_recorder().dump_state()
            except Exception:
                yield "hotspots", None
        if ds is not None:
            try:
                yield "device", ds.device_page_payload(server)
            except Exception:
                yield "device", None
        if bs is not None:
            try:
                yield "backends", bs.backends_page_payload()
            except Exception:
                yield "backends", None
        # serving flight deck: the /serving payload (batcher + engine +
        # per-method stage panes) joins the bundle whenever the serving
        # lane is loaded — resolved through sys.modules (a read, never
        # an import on the bundler thread), so a TTFT break's artifact
        # carries the step ring that explains it
        srv = sys.modules.get("brpc_tpu_torch.serving.service")
        if srv is not None and server is not None:
            try:
                yield "serving", srv.serving_page_payload(server)
            except Exception:
                yield "serving", None
        if sm is not None:
            try:
                label = f"incident #{inc.id}"
                rows = []
                for span in reversed(
                        sm.global_collector.recent(256)):
                    if any(label in t for _, t in span.annotations):
                        rows.append(span.to_dict())
                        if len(rows) >= _SPAN_BUNDLE_MAX:
                            break
                yield "spans", rows
            except Exception:
                yield "spans", None

    def _enforce_disk_budget(self, base: str, keep: str = "") -> None:
        """Oldest artifacts evicted first; the just-written one is
        never evicted (newest survives even when it alone exceeds the
        budget — a budget that deletes the only evidence is no
        budget)."""
        budget = int(flag("incident_disk_budget_mb")) << 20
        try:
            entries = []
            for p in artifact_files(base):
                try:
                    entries.append((p, os.stat(p).st_size))
                except OSError:
                    pass
            total = sum(sz for _, sz in entries)
            for p, sz in entries:
                if total <= budget:
                    break
                if p == keep:
                    continue
                try:
                    os.remove(p)
                except OSError:
                    continue
                try:
                    os.remove(p + ".idx")
                except OSError:
                    pass
                total -= sz
                with self._lock:
                    self.evicted += 1
        except OSError:
            pass

    # ----------------------------------------------------------- reads
    def _refresh_ledger_locked(self, base: str) -> None:
        # caller holds self._lock; artifact_summary reads sidecars
        # (O(1) per artifact) — acceptable under a leaf on a page read
        rows = []
        total = 0
        for p in artifact_files(base):
            s = artifact_summary(p)
            size = s.get("file_size") or 0
            total += max(0, size)
            rows.append({
                "path": p, "bytes": size,
                "incident_id": s.get("incident_id"),
                "peak_key": s.get("peak_key"),
                "keys": s.get("keys"),
                "opened_t": s.get("opened_t"),
                "corpus_records": s.get("corpus_records"),
                "snapshots": s.get("snapshots"),
            })
        self._artifacts = rows
        self._artifact_bytes = total
        self._scanned_dir = base

    def artifact_rows(self) -> List[dict]:
        """Page-read path: rescans the artifact dir when it changed
        (never called from the sampler thread)."""
        base = str(flag("incident_dir"))
        with self._lock:
            if not base:
                return []
            if self._scanned_dir != base:
                self._refresh_ledger_locked(base)
            return [dict(r) for r in self._artifacts]

    def prime_artifact_ledger(self) -> None:
        """Caller-thread scan (Server.start): artifacts surviving a
        restart show up in the bvars without waiting for a page read."""
        base = str(flag("incident_dir"))
        if not base:
            return
        with self._lock:
            if self._scanned_dir != base:
                self._refresh_ledger_locked(base)

    def artifact_bytes_cached(self) -> int:
        """Sampler-safe: one int read, no lock, no disk — the
        incident_artifact_bytes bvar is sampled on the series tick."""
        return self._artifact_bytes

    def window_open_now(self) -> int:
        return 1 if self.window_engaged else 0

    def incidents_state_payload(self) -> dict:
        """The /incidents page body (local, single process); the
        supervisor serves ShardAggregator.merged_incidents instead."""
        rows = self.artifact_rows()
        with self._lock:
            inc = self._incident
            out = {
                "enabled": bool(flag("incident_capture_enabled")),
                "dir": str(flag("incident_dir")),
                "window_ticks": int(flag("incident_window_ticks")),
                "max_artifact_mb": int(flag("incident_max_artifact_mb")),
                "disk_budget_mb": int(flag("incident_disk_budget_mb")),
                "open": 1 if self.window_engaged else 0,
                "window_left": self._window_left,
                "bundling": self._bundling,
                "capturing": self._capture_flipped,
                "active_incident": inc.to_dict()
                if inc is not None else None,
                "total": self.bundled,
                "evicted": self.evicted,
                "skipped": self.skipped,
                "artifact_bytes": self._artifact_bytes,
                "last_error": self.last_error,
                "pid": os.getpid(),
            }
        out["artifacts"] = rows
        return out

    def attach_serving_server(self, server) -> None:
        self._server_ref = weakref.ref(server)


# ------------------------------------------------------------ singleton

_manager = IncidentManager()


def global_manager() -> IncidentManager:
    return _manager


def incident_sample_tick(opened, closed, t: int) -> None:
    """The watchdog's per-tick hand-off (bvar/anomaly.py), marker-named
    so the sampler-no-lazy-import rule roots its closure here. Idle
    early-out is ONE attribute check."""
    m = _manager
    if opened is None and closed is None and not m.window_engaged:
        return
    m.incident_window_pass(opened, closed, t)


def attach_incident_server(server) -> None:
    """Server.start hook: the bundler's /status snapshot needs the
    serving Server (held weakly — the manager must not keep a stopped
    server alive), and artifacts surviving a restart are primed into
    the ledger here, on the caller thread."""
    _manager.attach_serving_server(server)
    _manager.prime_artifact_ledger()


def incidents_snapshot_payload(server=None) -> dict:
    """ONE builder for the /incidents page: HTTP handler, builtin-RPC
    twin and the shard dump all call this."""
    return _manager.incidents_state_payload()


def incident_status_line() -> dict:
    """The /status page's incidents line (cached bytes — /status must
    stay cheap; /incidents does the authoritative scan)."""
    m = _manager
    return {"open": m.window_open_now(), "total": m.bundled,
            "artifact_bytes": m.artifact_bytes_cached(),
            "url": "/incidents"}


# /vars: exposed at import, exposed again by expose_incident_vars at
# every Server.start (so they outlive an unexpose_all). Passives read the
# live singleton so a postfork replacement is picked up transparently.
nbundled = Adder().expose("incident_total")
_open_var = PassiveStatus(
    lambda: _manager.window_open_now()).expose("incident_open")
_bytes_var = PassiveStatus(
    lambda: _manager.artifact_bytes_cached()).expose(
        "incident_artifact_bytes")


def expose_incident_vars() -> None:
    """Re-expose the incident bvars after an unexpose_all (test
    harnesses between Server.start calls)."""
    nbundled.expose("incident_total")
    _open_var.expose("incident_open")
    _bytes_var.expose("incident_artifact_bytes")


def _postfork_reset() -> None:
    """Fork hygiene: the window, spool and ledger describe the PARENT;
    a shard child starts idle with a fresh leaf lock (the parent's may
    be mid-hold at fork time)."""
    global _manager
    _manager = IncidentManager()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("incident.manager", _postfork_reset)
