"""Network services: raw TCP in/out, SBS/BaseStation output, HTTP map server
(a copy of dump1090_tpu/io/net.py, but for the end of the event-loop
thread: on stop or a failed bind it also closes the listeners already
bound, ends the client handlers and closes the loop).

Behavioral contract: dump1090.c:2246-2767 (service table :2258-2272, accept
loop :2300-2337, broadcast :2365-2378, raw protocol :2380-2502, HTTP
:2504-2651, line framing :2665-2734).

Architecture: the reference polls nonblocking sockets between decode buffers
from a single thread.  Here the serving plane is an asyncio event loop on a
dedicated host thread — the device decode never blocks on sockets, and
broadcasts are handed over with loop.call_soon_threadsafe.  Wire formats are
byte-identical; the `Server: Dump1090` header is kept for client
compatibility.
"""

from __future__ import annotations

import asyncio
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from ..constants import (
    NET_HTTP_PORT,
    NET_INPUT_RAW_PORT,
    NET_OUTPUT_RAW_PORT,
    NET_OUTPUT_SBS_PORT,
)

CONTENT_TYPE_HTML = "text/html;charset=utf-8"
CONTENT_TYPE_JSON = "application/json;charset=utf-8"


@dataclass
class NetConfig:
    ro_port: int = NET_OUTPUT_RAW_PORT    # raw output (30002)
    ri_port: int = NET_INPUT_RAW_PORT     # raw input (30001)
    http_port: int = NET_HTTP_PORT        # HTTP (8080)
    sbs_port: int = NET_OUTPUT_SBS_PORT   # BaseStation output (30003)
    bind_host: str = "0.0.0.0"
    gmap_path: str = "gmap.html"          # read from CWD at request time, like the reference
    debug_net: bool = False               # --debug n logging (dump1090.c:2309-2593)


class NetworkServices:
    """All four TCP services on a background asyncio loop."""

    def __init__(
        self,
        cfg: NetConfig,
        *,
        on_raw_line: Callable[[str], None],
        data_json: Callable[[], str],
        on_http_request: Callable[[], None] | None = None,
        on_sbs_connect: Callable[[], None] | None = None,
    ):
        self.cfg = cfg
        self.on_raw_line = on_raw_line
        self.data_json = data_json
        self.on_http_request = on_http_request or (lambda: None)
        self.on_sbs_connect = on_sbs_connect or (lambda: None)
        self._raw_clients: set[asyncio.StreamWriter] = set()
        self._sbs_clients: set[asyncio.StreamWriter] = set()
        self.loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._start_error: OSError | None = None
        self._servers: list[asyncio.base_events.Server] = []
        # broadcast coalescing: the decode thread appends here and at most
        # ONE drain callback is in flight on the loop, which batches every
        # pending line into a single write per client (a file decode can
        # emit messages orders of magnitude faster than per-message
        # call_soon_threadsafe callbacks drain — an unbounded callback
        # backlog starves accepts and grows memory)
        self._pend_lock = threading.Lock()
        self._pending: list[tuple[set, bytes]] = []
        self._drain_scheduled = False

    def _log(self, msg: str, end: str = "\n") -> None:
        # --debug n lines go to STDOUT with reference wording
        # (dump1090.c:2334-2335, 2345-2346, 2569-2570, 2590-2592, 2638-2639)
        if self.cfg.debug_net:
            import sys

            sys.stdout.write(msg + end)
            sys.stdout.flush()

    @staticmethod
    def _fd(writer) -> int:
        sock = writer.get_extra_info("socket")
        try:
            return sock.fileno() if sock is not None else -1
        except OSError:
            return -1

    def _log_new(self, fd: int) -> None:
        self._log(f"Created new client {fd}")

    def _log_close(self, fd: int) -> None:
        self._log(f"Closing client {fd}")

    # ---- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="net", daemon=True)
        self._thread.start()
        self._started.wait(timeout=10)
        if self._start_error is not None:
            # fail fast like the reference when a port cannot be bound
            raise self._start_error

    def _run(self) -> None:
        self.loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self._start_servers())
        except OSError as e:  # e.g. EADDRINUSE
            self._start_error = e
        else:
            self._started.set()
            self.loop.run_forever()
        # on stop or a failed bind: close the listeners (those bound before
        # the failure too), end every client handler (each closes its socket
        # in its finally) and close the loop, so no handler is left
        # suspended on a loop that is gone
        for s in self._servers:
            s.close()
        tasks = asyncio.all_tasks(self.loop)
        for t in tasks:
            t.cancel()
        self.loop.run_until_complete(asyncio.gather(*tasks, return_exceptions=True))
        self.loop.close()
        self._started.set()  # a failed start is raised once all this is done

    def bind_error_message(self) -> str | None:
        """Reference-worded line for a failed service bind
        (modesInitNet, dump1090.c:2282-2289), or None."""
        e = self._start_error
        if e is None:
            return None
        import os as _os

        descr = getattr(e, "modes_descr", "?")
        port = getattr(e, "modes_port", 0)
        reason = _os.strerror(e.errno) if e.errno else str(e)
        return f"Error opening the listening port {port} ({descr}): {reason}"

    async def _start_servers(self) -> None:
        # bind order AND descriptions mirror modesNetServices
        # (dump1090.c:2263-2272): the first failing bind names the service
        c = self.cfg
        services = [
            ("Raw TCP output", c.ro_port, self._serve_raw_out),
            ("Raw TCP input", c.ri_port, self._serve_raw_in),
            ("HTTP server", c.http_port, self._serve_http),
            ("Basestation TCP output", c.sbs_port, self._serve_sbs),
        ]
        self._servers = []
        for descr, port, handler in services:
            try:
                self._servers.append(
                    await asyncio.start_server(handler, c.bind_host, port)
                )
            except OSError as e:
                e.modes_descr = descr
                e.modes_port = port
                raise

    def stop(self) -> None:
        if self.loop is not None:
            try:
                self.loop.call_soon_threadsafe(self.loop.stop)
            except RuntimeError:  # the loop is closed already (a failed start)
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)

    # ---- broadcast (thread-safe entry points from the decode thread) ------

    def broadcast_raw(self, text: str) -> None:
        self._broadcast(self._raw_clients, text)

    def broadcast_sbs(self, text: str) -> None:
        self._broadcast(self._sbs_clients, text)

    # drop clients whose socket has this much unsent data — the reference
    # drops a client on any short write (dump1090.c:2372-2375); asyncio
    # buffers instead, which must be bounded or a stalled reader leaks
    # memory without limit
    MAX_WRITE_BUFFER = 1 << 20

    def _broadcast(self, clients: set, text: str) -> None:
        if self.loop is None or not clients:
            return
        data = text.encode()
        with self._pend_lock:
            self._pending.append((clients, data))
            if self._drain_scheduled:
                return
            self._drain_scheduled = True
        try:
            self.loop.call_soon_threadsafe(self._drain_broadcasts)
        except RuntimeError:  # loop already closed (shutdown race)
            with self._pend_lock:
                self._drain_scheduled = False

    def _drain_broadcasts(self) -> None:
        """Loop-side: flush every pending broadcast, one joined write per
        client set — so a burst of N messages costs one callback and one
        write, not N of each."""
        while True:
            with self._pend_lock:
                items = self._pending
                self._pending = []
                if not items:
                    self._drain_scheduled = False
                    return
            # group consecutive lines by destination set (raw and sbs
            # interleave rarely; join preserves per-set emission order) —
            # capped per write so the MAX_WRITE_BUFFER drop check below
            # still fires while a stalled client's buffer grows
            join_cap = 256 << 10
            k = 0
            while k < len(items):
                clients, data = items[k]
                size = len(data)
                j = k + 1
                while (j < len(items) and items[j][0] is clients
                       and size < join_cap):
                    size += len(items[j][1])
                    j += 1
                if j > k + 1:
                    data = b"".join(d for _, d in items[k:j])
                k = j
                for w in list(clients):
                    try:
                        if (w.transport.get_write_buffer_size()
                                > self.MAX_WRITE_BUFFER):
                            # reference drops a client on any short write
                            # (dump1090.c:2372-2375 → modesFreeClient)
                            fd = self._fd(w)
                            clients.discard(w)
                            w.close()
                            self._log_close(fd)
                            continue
                        w.write(data)
                    except Exception:
                        clients.discard(w)

    # ---- raw output 30002: write-only clients ------------------------------

    async def _serve_raw_out(self, reader, writer) -> None:
        fd = self._fd(writer)
        self._raw_clients.add(writer)
        self._log_new(fd)
        try:
            while await reader.read(4096):
                pass  # reference never reads raw-out clients; drain politely
        except Exception:
            pass
        finally:
            self._raw_clients.discard(writer)
            writer.close()
            self._log_close(fd)

    # ---- raw input 30001: line-framed `*<hex>;` ----------------------------

    async def _serve_raw_in(self, reader, writer) -> None:
        fd = self._fd(writer)
        self._log_new(fd)
        try:
            # Exact emulation of the reference's client read buffer
            # (modesReadFromClient, dump1090.c:2665-2719): a 1024-byte
            # (MODES_CLIENT_BUF_SIZE) accumulator, '\n'-framed extraction,
            # and a full-buffer RESET when 1024 bytes pile up without a
            # separator — which discards the 1024-byte *prefix* while
            # keeping both the client and the bytes that follow (so a valid
            # `*hex;` after ≥1 KiB of unterminated junk on the same "line"
            # is still decoded, exactly like the reference).  The algorithm
            # is TCP-chunking-independent because the cap applies to the
            # accumulator, not to individual reads.  readline() would
            # instead raise past the stream limit and drop the connection.
            buf = b""
            while True:
                chunk = await reader.read(4096)
                if not chunk:
                    break
                pos = 0
                while pos < len(chunk):
                    take = min(1024 - len(buf), len(chunk) - pos)
                    buf += chunk[pos:pos + take]
                    pos += take
                    while True:
                        # strstr() framing can't see past a NUL byte: an
                        # embedded NUL poisons the buffer — every later
                        # '\n' (and line) is invisible and gets discarded
                        # by the next full-buffer reset (verified live:
                        # the reference stalls on `*hex;\0junk\n` until
                        # 1024 bytes accumulate).  Search only up to the
                        # first NUL, exactly like strstr.
                        stop = buf.find(b"\0")
                        region = buf if stop < 0 else buf[:stop]
                        i = region.find(b"\n")
                        if i < 0:
                            break
                        line, buf = buf[:i], buf[i + 1:]
                        if line:
                            self.on_raw_line(
                                (line + b"\n").decode("ascii", "replace")
                            )
                    if len(buf) == 1024:
                        buf = b""  # full-buffer garbage reset
        except Exception:
            pass
        finally:
            writer.close()
            self._log_close(fd)

    # ---- SBS output 30003 ---------------------------------------------------

    async def _serve_sbs(self, reader, writer) -> None:
        fd = self._fd(writer)
        self._sbs_clients.add(writer)
        self._log_new(fd)
        self.on_sbs_connect()
        try:
            while await reader.read(4096):
                pass
        except Exception:
            pass
        finally:
            self._sbs_clients.discard(writer)
            writer.close()
            self._log_close(fd)

    # ---- HTTP 8080 ----------------------------------------------------------

    async def _serve_http(self, reader, writer) -> None:
        fd = self._fd(writer)
        self._log_new(fd)
        try:
            while True:
                # request framed on \r\n\r\n (dump1090.c:2731-2732)
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
                    break
                text = head.decode("latin-1")
                keepalive = self._keepalive(text)
                url = self._url(text)
                if url is None:
                    break
                # handleHTTPRequest's debug prints (dump1090.c:2569-2570,
                # 2590-2592): the raw request buffer, then keepalive + URL.
                # The reference NUL-terminates the buffer AT the \r\n\r\n
                # separator before the handler runs (dump1090.c:2692), so
                # the dumped request excludes it — including the final
                # header line's own \r\n, which the separator match eats.
                self._log(f"\nHTTP request: {text[:-4]}")
                self._log(f"\nHTTP keep alive: {int(keepalive)}")
                self._log(f"HTTP requested URL: {url}\n")
                if "/data.json" in url:
                    content = self.data_json().encode()
                    ctype = CONTENT_TYPE_JSON
                else:
                    content, ctype = self._page_content()
                hdr = (
                    "HTTP/1.1 200 OK\r\n"
                    "Server: Dump1090\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Connection: {'keep-alive' if keepalive else 'close'}\r\n"
                    f"Content-Length: {len(content)}\r\n"
                    "Access-Control-Allow-Origin: *\r\n"
                    "\r\n"
                )
                # dump1090.c:2638-2639: the raw reply header, no added newline
                self._log("HTTP Reply header:\n" + hdr, end="")
                writer.write(hdr.encode() + content)
                await writer.drain()
                self.on_http_request()
                if not keepalive:
                    break
        except Exception:
            pass
        finally:
            writer.close()
            self._log_close(fd)

    @staticmethod
    def _keepalive(head: str) -> bool:
        if "HTTP/1.1" in head:
            return "Connection: close" not in head
        return "Connection: keep-alive" in head

    @staticmethod
    def _url(head: str) -> str | None:
        sp = head.find(" ")
        if sp < 0:
            return None
        sp2 = head.find(" ", sp + 1)
        if sp2 < 0:
            return None
        return head[sp + 1 : sp2]

    def _page_content(self) -> tuple[bytes, str]:
        # like the reference, the map page is read from CWD at request time
        # (dump1090.c:2602-2623), falling back to the packaged asset
        p = Path(self.cfg.gmap_path)
        if not p.exists():
            p = Path(__file__).parent / "http_assets" / "gmap.html"
        try:
            return p.read_bytes(), CONTENT_TYPE_HTML
        except OSError as e:
            return f"Error opening HTML file: {e}".encode(), CONTENT_TYPE_HTML
