"""Tabbed HTML index over the builtin pages (the port of
brpc_tpu/builtin/tabbed.py; builtin/tabbed.h): one self-contained page
that fetches the plain endpoints and shows them, so the JSON and text
pages stay script-friendly. The tabs are the pages the port has."""

from __future__ import annotations

import json

TABS = [
    ("status", "/status"),
    ("health", "/health"),
    ("vars", "/vars"),
    ("flags", "/flags"),
    ("rpcz", "/rpcz"),
    ("contentions", "/contentions"),
    ("serving", "/serving"),
    ("device", "/device"),
    ("connections", "/connections"),
    ("sockets", "/sockets"),
    ("ids", "/ids"),
    ("protobufs", "/protobufs"),
    ("metrics", "/brpc_metrics"),
    ("version", "/version"),
]

_PAGE = """<!doctype html>
<html><head><title>brpc_tpu_torch</title><style>
body {{ font-family: monospace; margin: 0; background: #fafafa; }}
nav {{ background: #263238; padding: 0 8px; position: sticky; top: 0; }}
nav a {{ display: inline-block; color: #cfd8dc; text-decoration: none;
        padding: 9px 10px; font-size: 13px; }}
nav a:hover {{ background: #37474f; color: #fff; }}
nav a.active {{ background: #00695c; color: #fff; }}
#services {{ padding: 8px 14px; color: #555; font-size: 12px;
             border-bottom: 1px solid #ddd; background: #fff; }}
pre {{ padding: 12px 14px; white-space: pre-wrap; word-break: break-all;
       font-size: 12px; }}
</style></head><body>
<nav>{tabs}</nav>
<div id="services">{services}</div>
<pre id="out">pick a tab</pre>
<script>
const tabs = {tabjson};
function show(name) {{
  const t = tabs.find(x => x[0] === name);
  if (!t) return;
  document.querySelectorAll('nav a').forEach(
    a => a.classList.toggle('active', a.dataset.tab === name));
  document.getElementById('out').textContent = 'loading ' + t[1] + ' ...';
  fetch(t[1]).then(r => r.text()).then(body => {{
    try {{ body = JSON.stringify(JSON.parse(body), null, 2); }}
    catch (e) {{}}
    document.getElementById('out').textContent = body;
  }}).catch(e => {{
    document.getElementById('out').textContent = 'fetch failed: ' + e;
  }});
  history.replaceState(null, '', '#' + name);
}}
document.querySelectorAll('nav a').forEach(a => a.onclick = (ev) => {{
  ev.preventDefault(); show(a.dataset.tab);
}});
if (location.hash) show(location.hash.slice(1));
</script></body></html>"""


def render_index(server) -> bytes:
    tabs_html = "".join(
        f'<a href="{url}" data-tab="{name}">{name}</a>'
        for name, url in TABS)
    services = " &nbsp; ".join(
        f"<b>{n}</b>({', '.join(sorted(s.methods))})"
        for n, s in server.services().items()) or "no services"
    return _PAGE.format(tabs=tabs_html, services=services,
                        tabjson=json.dumps(TABS)).encode()
