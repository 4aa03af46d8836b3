"""An echo server in a process of its own (the port of
tools/bench_echo_server.py), so that a load tool's clients and the
server each have their own interpreter::

    python3 -m brpc_tpu_torch.tools.bench_echo_server [PORT]

prints ``PORT <n>`` once it listens and exits when its parent dies. It
serves the ``Bench`` service: ``Echo`` (a ``native="echo"`` method; a
request's attachment goes back as the response's, unjoined), ``PyEcho``
(a plain Python handler), ``Slow`` (a 50 ms fiber sleep: the slow tail
of a latency benchmark) and ``StreamSink`` (counts a stream's bytes and
answers one ``done:<n>`` frame once the request's total arrived).

Its builtin pages answer (``/census``, ``/flags``, ``/status``): the
idle-connection soak reads them. brpc_tpu's server answers its pages
whatever ``enable_builtin_services`` says, the port's only when it is
set, so this server sets it.
"""

from __future__ import annotations

import sys


def add_echo_methods(svc) -> None:
    """``Echo`` and ``PyEcho`` on ``svc``: one definition for this server
    and every shard of ``tools.shard_server``."""

    @svc.method(native="echo")
    async def Echo(cntl, request):
        # small frames are served by the native core's echo loop with
        # these semantics; this handler takes the large ones and those
        # with an attachment, which flows back out as it came
        if cntl.request_attachment.size:
            cntl.response_attachment = cntl.request_attachment
        return request

    @svc.method()
    def PyEcho(cntl, request):
        # the plain Python dispatch: what a call costs on the framework's
        # own path, without the native echo loop
        return bytes(request)


def make_server():
    from brpc_tpu_torch.rpc import Server, ServerOptions, Service
    from brpc_tpu_torch.rpc.stream import StreamOptions, stream_accept

    server = Server(ServerOptions(enable_builtin_services=True))
    svc = Service("Bench")
    add_echo_methods(svc)

    @svc.method()
    async def Slow(cntl, request):
        from brpc_tpu_torch.fiber import sleep as fiber_sleep
        await fiber_sleep(0.05)
        return request

    @svc.method()
    def StreamSink(cntl, request):
        # the request carries the byte total to expect; one "done:<n>"
        # frame answers once it all arrived
        want = int(bytes(request) or b"0")
        state = {"got": 0, "done": False}

        def on_received(stream, msg):
            state["got"] += len(msg.payload)
            if state["got"] >= want and not state["done"]:
                state["done"] = True
                stream.write_nowait(b"done:%d" % state["got"])

        s = stream_accept(cntl, StreamOptions(on_received=on_received))
        if s is not None:
            # the accepted stream is the handler's: it closes on the
            # client's close, so that repeated runs leave no entries
            s.on_close(lambda st: st.close())
        return b"accepted"

    server.add_service(svc)
    return server


def main() -> None:
    # the idle-connection soak holds thousands of connections here
    try:
        import resource
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < hard:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except Exception:
        pass
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    server = make_server()
    ep = server.start(f"tcp://127.0.0.1:{port}")
    print(f"PORT {ep.port}", flush=True)
    from brpc_tpu_torch.tools.spawn_util import parent_death_watchdog_loop
    parent_death_watchdog_loop()


if __name__ == "__main__":
    main()
