"""Socket transport for the exchange SPI: pages across OS processes.

Counterpart of ``velox_tpu/exec/exchange_net.py``. The in-process
``LocalExchangeSource`` reads the producer's OutputBufferManager directly;
this module carries the same pull protocol (sequence numbers, implicit
acks, max_bytes credit, at_end) over a TCP socket, so that plan fragments
in different processes or hosts can be wired together: the DCN-boundary
analogue of Prestissimo's HTTP transport behind the reference engine's
pluggable factory (exec/ExchangeSource.h:137; protocol doc
exec/TaskDriverOperatorLifecycle.md:18-22).

Wire protocol (one request per connection round):
    request : "GET <task_id> <destination> <sequence> <max_bytes>\\n"
    response: "<n_pages> <at_end:0|1>\\n" then per page "<len>\\n" + bytes
``max_bytes < 0`` means no bound. The server reads the process-local
OutputBufferManager, so a producer runs its Task, then calls
``serve_exchange()``. Pages are bytes: each process uploads them onto the
device its own query names.
"""

from __future__ import annotations

import socket
import socketserver
import threading
from typing import Optional, Tuple

from velox_tpu_torch.exec.exchange import ExchangeSource, OutputBufferManager


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        line = self.rfile.readline().decode().split()
        if not line or line[0] != "GET":
            return
        task_id, dest, seq, max_bytes = (
            line[1], int(line[2]), int(line[3]), int(line[4]))
        from velox_tpu_torch.common import testvalue as TV
        TV.adjust("ExchangeNet::respond", (task_id, seq))
        buf = OutputBufferManager.instance().get(task_id)
        pages, at_end = buf.get(
            dest, seq, None if max_bytes < 0 else max_bytes)
        self.wfile.write(f"{len(pages)} {int(at_end)}\n".encode())
        for p in pages:
            self.wfile.write(f"{len(p)}\n".encode())
            self.wfile.write(p)


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


_SERVERS: list = []


def serve_exchange(host: str = "127.0.0.1",
                   port: int = 0) -> Tuple[str, int]:
    """Serve this process's OutputBufferManager over TCP on a daemon
    thread. Returns the bound (host, port). Servers stay up for the
    process's lifetime unless ``shutdown_exchange_servers()`` is called
    (a long-lived worker serves many queries; parity: the reference
    engine's task-output HTTP endpoint outliving any one task)."""
    server = _Server((host, port), _Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="velox-exchange-server")
    t.start()
    _SERVERS.append((server, t))
    return server.server_address[:2]


def shutdown_exchange_servers() -> None:
    """Stop every server ``serve_exchange`` started (tests, a worker's
    drain): close the listening sockets and join the accept threads."""
    while _SERVERS:
        server, t = _SERVERS.pop()
        try:
            server.shutdown()
            server.server_close()
        except OSError:
            pass
        t.join(timeout=5)


def _truncated(addr, what: str):
    from velox_tpu_torch.common.errors import VeloxRuntimeError
    return VeloxRuntimeError(f"exchange server at {addr} closed the "
                             f"connection mid-{what}")


class SocketExchangeSource(ExchangeSource):
    """Pulls pages for one (remote task, destination) over TCP.
    Addressing: a task id of the form "host:port/taskname" carries its own
    endpoint, as the reference engine embeds the producer URI in
    RemoteConnectorSplits (exec/Exchange.cpp:29)."""

    def __init__(self, task_id: str, destination: int):
        addr, _, self.task_name = task_id.rpartition("/")
        host, _, port = addr.rpartition(":")
        self.addr = (host, int(port))
        self.destination = destination
        self._seq = 0

    def next(self, max_bytes: Optional[int] = None):
        with socket.create_connection(self.addr, timeout=30) as s:
            f = s.makefile("rwb")
            f.write(f"GET {self.task_name} {self.destination} "
                    f"{self._seq} "
                    f"{-1 if max_bytes is None else max_bytes}\n"
                    .encode())
            f.flush()
            header = f.readline().decode().split()
            if len(header) != 2:
                raise _truncated(self.addr, "response (truncated header)")
            n, at_end = header
            pages = []
            for _ in range(int(n)):
                size = int(f.readline())
                page = f.read(size)
                if len(page) != size:
                    raise _truncated(self.addr, "page (truncated payload)")
                pages.append(page)
        self._seq += len(pages)
        return pages, bool(int(at_end))
