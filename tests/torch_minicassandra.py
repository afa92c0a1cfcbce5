"""A tiny in-process Cassandra speaking the CQL native protocol v4 over a
real TCP socket; a copy of ``tests/minicassandra.py`` whose wire helpers
come from the PyTorch port's ``store/cql.py``, so that a process without
the JAX package (``chip_smoke.py`` on the card's machine) can stand it in
for Cassandra.  STARTUP/AUTHENTICATE/AUTH_RESPONSE, QUERY, PREPARE/EXECUTE
with binary-bound values, and RESULT rows with typed columns (varchar,
bigint, float, map<text,text>, and Cassandra 5's VECTOR<FLOAT, n> custom
marshal).  Interprets just the CQL the store issues: keyspace/table/index
DDL, prepared INSERT upserts, ANN search with ``similarity_cosine``
scoring + metadata entry filters, metadata lookups, point gets, COUNT,
DELETE, and the system tables the health probe and ``tables()`` read.

A Python server: its rates say nothing about Cassandra's.
"""

from __future__ import annotations

import hashlib
import re
import struct
import threading
import socketserver

import numpy as np

from githubrepostorag_tpu_torch.store import cql as W  # wire helpers (the port's codec)

_VEC_CLS = "org.apache.cassandra.db.marshal.VectorType"


def _vector_type(dim: int):
    return ("vector", dim)


def _type_option(t) -> bytes:
    """Encode one type descriptor as a wire [option]."""
    if t[0] == "vector":
        cls = f"{_VEC_CLS}(org.apache.cassandra.db.marshal.FloatType, {t[1]})"
        return struct.pack(">H", W.TYPE_CUSTOM) + W._string(cls)
    if t[0] == "map":
        return struct.pack(">H", W.TYPE_MAP) + _type_option(t[1]) + _type_option(t[2])
    return struct.pack(">H", t[0])


class MiniCassandra:
    """In-memory tables: {name: {row_id: {body_blob, vector, metadata_s}}}."""

    def __init__(self, username: str = "cassandra", password: str = "cassandra") -> None:
        self.tables: dict[str, dict[str, dict]] = {}
        self.dims: dict[str, int] = {}
        self.keyspaces: set[str] = set()
        self.prepared: dict[bytes, str] = {}
        self.auth = (username, password)
        self.queries: list[str] = []  # every CQL text seen, for assertions
        self._server: socketserver.ThreadingTCPServer | None = None
        self.port: int | None = None

    # ---- lifecycle ----

    def start(self) -> int:
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:  # one client connection
                try:
                    outer._serve(self.request)
                except (ConnectionError, OSError):
                    pass

        self._server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self.port

    def stop(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()

    # ---- framing ----

    def _serve(self, sock) -> None:
        authed = False
        while True:
            header = _recv_exact(sock, 9)
            if header is None:
                return
            _v, _f, stream, op, length = struct.unpack(">BBhBi", header)
            body = _recv_exact(sock, length) if length else b""
            if body is None:
                return
            if op == W.OP_STARTUP:
                _send(sock, stream, W.OP_AUTHENTICATE,
                      W._string("org.apache.cassandra.auth.PasswordAuthenticator"))
            elif op == W.OP_AUTH_RESPONSE:
                buf = W._Buf(body)
                token = buf.bytes_() or b""
                parts = token.split(b"\x00")
                if parts[-2:] == [self.auth[0].encode(), self.auth[1].encode()]:
                    authed = True
                    _send(sock, stream, W.OP_AUTH_SUCCESS, W._bytes(None))
                else:
                    _send_error(sock, stream, 0x0100, "Bad credentials")
            elif not authed:
                _send_error(sock, stream, 0x0100, "Not authenticated")
            elif op == W.OP_QUERY:
                buf = W._Buf(body)
                cql = buf.long_string()
                self.queries.append(cql)
                try:
                    _send_result(sock, stream, self._run(cql))
                except _Unsupported as exc:
                    _send_error(sock, stream, 0x2000, str(exc))
            elif op == W.OP_PREPARE:
                buf = W._Buf(body)
                cql = buf.long_string()
                self.queries.append("PREPARE " + cql)
                _send(sock, stream, W.OP_RESULT, self._prepare(cql))
            elif op == W.OP_EXECUTE:
                buf = W._Buf(body)
                qid = buf.short_bytes()
                buf.u16()  # consistency
                flags = buf.u8()
                values = []
                if flags & 0x01:
                    n = buf.u16()
                    values = [buf.bytes_() for _ in range(n)]
                try:
                    _send_result(sock, stream, self._execute(qid, values))
                except _Unsupported as exc:
                    _send_error(sock, stream, 0x2000, str(exc))
            else:
                _send_error(sock, stream, 0x000A, f"opcode 0x{op:02X} unsupported")

    # ---- CQL interpretation ----

    def _prepare(self, cql: str) -> bytes:
        m = re.match(
            r"INSERT INTO (\w+)\.(\w+) \(row_id, body_blob, vector, metadata_s\)"
            r" VALUES \(\?, \?, \?, \?\)",
            cql,
        )
        if not m:
            raise _Unsupported(f"cannot prepare: {cql}")
        table = m.group(2)
        qid = hashlib.md5(cql.encode()).digest()
        self.prepared[qid] = table
        dim = self.dims.get(table, 384)
        types = [
            (W.TYPE_VARCHAR,), (W.TYPE_VARCHAR,), _vector_type(dim),
            ("map", (W.TYPE_VARCHAR,), (W.TYPE_VARCHAR,)),
        ]
        names = ["row_id", "body_blob", "vector", "metadata_s"]
        meta = struct.pack(">iii", 0x0001, len(types), 1) + struct.pack(">H", 0)
        meta += W._string("ks") + W._string(table)
        for name, t in zip(names, types):
            meta += W._string(name) + _type_option(t)
        result_meta = struct.pack(">ii", 0x0004, 0)  # no_metadata, 0 cols
        return (
            struct.pack(">i", W.RESULT_PREPARED)
            + struct.pack(">H", len(qid)) + qid
            + meta + result_meta
        )

    def _execute(self, qid: bytes, values: list[bytes | None]):
        table = self.prepared.get(qid)
        if table is None:
            raise _Unsupported("unknown prepared id")
        dim = self.dims.get(table, 384)
        row_id = W.decode_value((W.TYPE_VARCHAR,), values[0])
        body = W.decode_value((W.TYPE_VARCHAR,), values[1])
        vec = W.decode_value(_vector_type(dim), values[2])
        meta = W.decode_value(("map", (W.TYPE_VARCHAR,), (W.TYPE_VARCHAR,)), values[3])
        self.tables.setdefault(table, {})[row_id] = {
            "row_id": row_id, "body_blob": body, "vector": vec,
            "metadata_s": meta or {},
        }
        return ("void",)

    def _run(self, cql: str):
        cql = cql.strip()
        if m := re.match(r"CREATE KEYSPACE IF NOT EXISTS (\w+)", cql):
            self.keyspaces.add(m.group(1))
            return ("void",)
        if m := re.match(
            r"CREATE TABLE IF NOT EXISTS \w+\.(\w+) .*VECTOR<FLOAT, (\d+)>", cql
        ):
            self.tables.setdefault(m.group(1), {})
            self.dims[m.group(1)] = int(m.group(2))
            return ("void",)
        if cql.startswith("CREATE CUSTOM INDEX"):
            return ("void",)
        if re.match(r"SELECT release_version FROM system\.local", cql):
            return ("rows", ["release_version"], [(W.TYPE_VARCHAR,)], [["5.0-mini"]])
        if m := re.match(
            r"SELECT table_name FROM system_schema\.tables WHERE keyspace_name = '(\w+)'",
            cql,
        ):
            rows = [[t] for t in sorted(self.tables)]
            return ("rows", ["table_name"], [(W.TYPE_VARCHAR,)], rows)
        if m := re.match(r"SELECT COUNT\(\*\) AS n FROM \w+\.(\w+)", cql):
            n = len(self.tables.get(m.group(1), {}))
            return ("rows", ["n"], [(W.TYPE_BIGINT,)], [[n]])
        if m := re.match(r"DELETE FROM \w+\.(\w+) WHERE row_id = '((?:[^']|'')*)'", cql):
            self.tables.get(m.group(1), {}).pop(_unesc(m.group(2)), None)
            return ("void",)
        if m := re.match(
            r"SELECT row_id FROM \w+\.(\w+) WHERE row_id = '((?:[^']|'')*)'", cql
        ):
            row = self.tables.get(m.group(1), {}).get(_unesc(m.group(2)))
            rows = [[row["row_id"]]] if row else []
            return ("rows", ["row_id"], [(W.TYPE_VARCHAR,)], rows)
        if "ORDER BY vector ANN OF" in cql:
            return self._ann(cql)
        if m := re.match(
            r"SELECT row_id, body_blob, metadata_s, vector FROM \w+\.(\w+) "
            r"WHERE row_id = '((?:[^']|'')*)'",
            cql,
        ):
            row = self.tables.get(m.group(1), {}).get(_unesc(m.group(2)))
            return self._doc_rows(m.group(1), [row] if row else [])
        if m := re.match(
            r"SELECT row_id, body_blob, metadata_s, vector FROM \w+\.(\w+)\s*"
            r"(?:WHERE (.*?))? LIMIT (\d+)$",
            cql,
        ):
            rows = self._filtered(m.group(1), m.group(2))
            return self._doc_rows(m.group(1), rows[: int(m.group(3))])
        raise _Unsupported(f"cannot interpret: {cql}")

    def _filtered(self, table: str, where: str | None) -> list[dict]:
        rows = list(self.tables.get(table, {}).values())
        for key, val in _where_pairs(where):
            rows = [r for r in rows if r["metadata_s"].get(key) == val]
        return rows

    def _ann(self, cql: str):
        m = re.match(
            r"SELECT row_id, body_blob, metadata_s, vector, "
            r"similarity_cosine\(vector, (\[[^\]]*\])\) AS score "
            r"FROM \w+\.(\w+)(?: WHERE (.*?))? ORDER BY vector ANN OF "
            r"(\[[^\]]*\]) LIMIT (\d+)$",
            cql,
        )
        if not m:
            raise _Unsupported(f"cannot parse ANN query: {cql}")
        qv = np.asarray(eval(m.group(1)), dtype=np.float32)  # noqa: S307 - literal list
        table, where, limit = m.group(2), m.group(3), int(m.group(5))
        rows = self._filtered(table, where)
        scored = []
        for r in rows:
            v = r["vector"]
            denom = float(np.linalg.norm(qv) * np.linalg.norm(v)) or 1e-9
            # Cassandra similarity_cosine maps cosine to [0, 1]
            score = (1.0 + float(np.dot(qv, v)) / denom) / 2.0
            scored.append((score, r))
        scored.sort(key=lambda sr: -sr[0])
        dim = self.dims.get(table, 384)
        names = ["row_id", "body_blob", "metadata_s", "vector", "score"]
        types = [
            (W.TYPE_VARCHAR,), (W.TYPE_VARCHAR,),
            ("map", (W.TYPE_VARCHAR,), (W.TYPE_VARCHAR,)),
            _vector_type(dim), (W.TYPE_FLOAT,),
        ]
        out = [
            [r["row_id"], r["body_blob"], r["metadata_s"], r["vector"], s]
            for s, r in scored[:limit]
        ]
        return ("rows", names, types, out)

    def _doc_rows(self, table: str, rows: list[dict]):
        dim = self.dims.get(table, 384)
        names = ["row_id", "body_blob", "metadata_s", "vector"]
        types = [
            (W.TYPE_VARCHAR,), (W.TYPE_VARCHAR,),
            ("map", (W.TYPE_VARCHAR,), (W.TYPE_VARCHAR,)),
            _vector_type(dim),
        ]
        out = [[r["row_id"], r["body_blob"], r["metadata_s"], r["vector"]] for r in rows]
        return ("rows", names, types, out)


class _Unsupported(Exception):
    pass


def _unesc(s: str) -> str:
    return s.replace("''", "'")


def _where_pairs(where: str | None) -> list[tuple[str, str]]:
    if not where:
        return []
    pairs = []
    for m in re.finditer(
        r"metadata_s\['((?:[^']|'')*)'\] = '((?:[^']|'')*)'", where
    ):
        pairs.append((_unesc(m.group(1)), _unesc(m.group(2))))
    return pairs


# ---- response encoding ---------------------------------------------------


def _recv_exact(sock, n: int) -> bytes | None:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            return None
        out += chunk
    return out


def _send(sock, stream: int, opcode: int, body: bytes) -> None:
    sock.sendall(
        struct.pack(">BBhBi", W.VERSION_RESP, 0, stream, opcode, len(body)) + body
    )


def _send_error(sock, stream: int, code: int, msg: str) -> None:
    _send(sock, stream, W.OP_ERROR, struct.pack(">i", code) + W._string(msg))


def _send_result(sock, stream: int, result) -> None:
    if result[0] == "void":
        _send(sock, stream, W.OP_RESULT, struct.pack(">i", W.RESULT_VOID))
        return
    _kind, names, types, rows = result
    parts = [struct.pack(">i", W.RESULT_ROWS),
             struct.pack(">ii", 0x0001, len(names)),  # global_tables_spec
             W._string("ks") + W._string("t")]
    for name, t in zip(names, types):
        parts.append(W._string(name) + _type_option(t))
    parts.append(struct.pack(">i", len(rows)))
    # one join, not += per value: a seed read returns tens of MB
    parts.extend(W._bytes(W.encode_value(t, v)) for row in rows for t, v in zip(types, row))
    _send(sock, stream, W.OP_RESULT, b"".join(parts))
