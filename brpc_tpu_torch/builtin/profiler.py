"""/hotspots rendering and heap profiles (the port of
brpc_tpu/builtin/profiler.py; builtin/hotspots_service.cpp, which shells
into gperftools where a Python process profiles itself).

The sampling lives in ``builtin/flight_recorder.py``: its thread walks
``sys._current_frames()`` and runs the on-demand jobs too, so the page's
handler never holds a worker for the sample window. This module renders:
the text top-N, folded stacks for flamegraph.pl, a self-contained SVG
flamegraph, and the tracemalloc heap and growth pages."""

from __future__ import annotations

import threading
import zlib
from collections import Counter
from typing import List


def render_text(leaves: Counter, nsamples: int, top: int = 40) -> str:
    if nsamples == 0:
        return "no samples (process idle?)\n"
    lines = [f"{nsamples} samples\n", "count  pct  function\n"]
    for fn, n in leaves.most_common(top):
        lines.append(f"{n:6d} {100.0 * n / nsamples:4.1f}%  {fn}\n")
    return "".join(lines)


def render_flamegraph_svg(folded: Counter, width: int = 1200,
                          row_h: int = 16) -> str:
    """Self-contained SVG flamegraph from folded stacks (the reference
    embeds flamegraph rendering behind /hotspots via pprof_perl.cpp;
    this is the same icicle layout generated directly — hover a frame
    for its full name and sample share)."""
    root: dict = {"n": "all", "v": 0, "c": {}}
    for stack, count in folded.items():
        root["v"] += count
        node = root
        for frame in stack.split(";"):
            nxt = node["c"].get(frame)
            if nxt is None:
                nxt = node["c"][frame] = {"n": frame, "v": 0, "c": {}}
            node = nxt
            node["v"] += count
    total = root["v"] or 1

    rects: List[str] = []
    max_depth = [0]

    def color(name: str) -> str:
        h = zlib.crc32(name.encode()) & 0xFFFF
        return f"hsl({20 + h % 40},{70 + h % 25}%,{55 + (h >> 8) % 12}%)"

    def esc(s: str) -> str:
        return (s.replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;").replace('"', "&quot;"))

    def emit(node, x: float, depth: int):
        w = node["v"] / total * width
        if w < 0.5:
            return
        max_depth[0] = max(max_depth[0], depth)
        y = depth * row_h
        pct = node["v"] / total * 100
        label = esc(node["n"])
        # truncate the RAW name, then escape: slicing escaped text can
        # cut an XML entity in half and invalidate the whole SVG
        short = esc(node["n"][:int(w / 7)])
        rects.append(
            f'<g><title>{label} ({node["v"]} samples, {pct:.1f}%)</title>'
            f'<rect x="{x:.1f}" y="{y}" width="{w:.1f}" height="{row_h - 1}"'
            f' fill="{color(node["n"])}" rx="1"/>'
            + (f'<text x="{x + 2:.1f}" y="{y + row_h - 4}" '
               f'font-size="11" font-family="monospace">'
               f'{short}</text>' if w > 28 else "")
            + "</g>")
        cx = x
        for child in sorted(node["c"].values(), key=lambda c: -c["v"]):
            emit(child, cx, depth + 1)
            cx += child["v"] / total * width

    emit(root, 0.0, 0)
    height = (max_depth[0] + 1) * row_h + 4
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}" font-family="sans-serif">'
            + "".join(rects) + "</svg>")


def render_folded(folded: Counter) -> str:
    """flamegraph.pl-compatible: 'frame;frame;frame count' per line."""
    return "".join(f"{stack} {n}\n" for stack, n in folded.most_common())


# ------------------------------------------------------------------ heap
# tracemalloc-backed heap/growth profiles: the /hotspots?type=heap and
# type=growth pages (reference: MallocExtension heap/growth samples via
# details/tcmalloc_extension.h + hotspots_service.cpp). tracemalloc has
# runtime cost, so tracing starts on FIRST request and the page says so.

_growth_baseline = None
_heap_lock = threading.Lock()


def heap_profile(top: int = 40) -> str:
    """Top allocation sites by live bytes (start tracing on first call)."""
    import tracemalloc
    with _heap_lock:
        if not tracemalloc.is_tracing():
            tracemalloc.start(16)
            return ("heap tracing STARTED (tracemalloc, 16 frames); "
                    "allocations from this point on are tracked — "
                    "request this page again for the profile\n")
        snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")
    total = sum(s.size for s in stats)
    out = [f"live traced bytes: {total} in {len(stats)} sites "
           f"(top {top})\n", f"{'bytes':>12} {'count':>8}  site\n"]
    for s in stats[:top]:
        frame = s.traceback[0]
        out.append(f"{s.size:>12} {s.count:>8}  "
                   f"{frame.filename}:{frame.lineno}\n")
    return "".join(out)


def growth_profile(top: int = 40) -> str:
    """Allocation growth since the previous growth snapshot (the
    MallocExtension growth-profile slot)."""
    import tracemalloc
    global _growth_baseline
    with _heap_lock:
        if not tracemalloc.is_tracing():
            tracemalloc.start(16)
            return ("heap tracing STARTED; request this page again to "
                    "set the growth baseline\n")
        snap = tracemalloc.take_snapshot()
        prev, _growth_baseline = _growth_baseline, snap
    if prev is None:
        return "growth baseline SET; request again to see the delta\n"
    stats = snap.compare_to(prev, "lineno")
    out = [f"{'delta_bytes':>12} {'delta_cnt':>10}  site (top {top}, "
           f"since last request)\n"]
    for s in stats[:top]:
        frame = s.traceback[0]
        out.append(f"{s.size_diff:>12} {s.count_diff:>10}  "
                   f"{frame.filename}:{frame.lineno}\n")
    return "".join(out)


def heap_stop() -> str:
    """Stop tracemalloc tracing (it costs ~2x on allocation-heavy code;
    the page exposes ?type=heap&stop=1 to turn it back off)."""
    import tracemalloc
    global _growth_baseline
    with _heap_lock:
        _growth_baseline = None
        if tracemalloc.is_tracing():
            tracemalloc.stop()
            return "heap tracing STOPPED\n"
        return "heap tracing was not running\n"
