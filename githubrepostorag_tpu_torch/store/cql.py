"""In-tree CQL native-protocol v4 client; a copy of
``githubrepostorag_tpu/store/cql.py``.  The Cassandra counterpart of the
in-tree RESP2 Redis client (events/resp.py): no out-of-tree driver, just
the wire protocol this framework actually uses, spoken directly.

The reference's storage path rides the DataStax ``cassandra-driver``
(ingest/src/app/services/cassandra_service.py:130-160 builds Cluster +
PlainTextAuthProvider).  The framework needs only a narrow session
surface:

  - ``execute(cql)``                  — DDL / simple statements
  - ``execute(cql, params)``          — %s params, client-side interpolated
                                        (the DataStax driver does the same
                                        for simple statements)
  - ``prepare(cql)`` / ``execute(stmt, params)`` — server-side binary
                                        binding via PREPARE/EXECUTE
  - row objects with attribute access and ``rows.one()``

Protocol subset (native_protocol_v4.spec): STARTUP -> (AUTHENTICATE ->
AUTH_RESPONSE [PlainText] -> AUTH_SUCCESS | READY), QUERY, PREPARE,
EXECUTE, RESULT (void / rows / set_keyspace / prepared / schema_change),
ERROR.  Types covered: varchar/ascii, int, bigint, float, double, boolean,
map<text,text>, list/set, and Cassandra 5's VectorType custom marshal
(fixed-width concatenated big-endian floats) for VECTOR<FLOAT, n> columns.

Result paging is not requested (no page-size flag): statements this store
issues are LIMIT-bounded far below the server's default page.  Tested
wire-level against tests/minicassandra.py and tests/torch_minicassandra.py,
real TCP servers speaking this same protocol (tests/test_torch_stores.py).
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Iterator, Mapping, Sequence

import numpy as np

from githubrepostorag_tpu_torch.resilience.faults import InjectedFault, fire_sync

# ---- opcodes / constants -------------------------------------------------

VERSION_REQ = 0x04
VERSION_RESP = 0x84

OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_PREPARE = 0x09
OP_EXECUTE = 0x0A
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

RESULT_VOID = 0x0001
RESULT_ROWS = 0x0002
RESULT_SET_KEYSPACE = 0x0003
RESULT_PREPARED = 0x0004
RESULT_SCHEMA_CHANGE = 0x0005

CONSISTENCY_ONE = 0x0001

TYPE_CUSTOM = 0x0000
TYPE_ASCII = 0x0001
TYPE_BIGINT = 0x0002
TYPE_BOOLEAN = 0x0004
TYPE_COUNTER = 0x0005
TYPE_DOUBLE = 0x0007
TYPE_FLOAT = 0x0008
TYPE_INT = 0x0009
TYPE_VARCHAR = 0x000D
TYPE_LIST = 0x0020
TYPE_MAP = 0x0021
TYPE_SET = 0x0022

_VECTOR_MARSHAL = "org.apache.cassandra.db.marshal.VectorType"


class CQLError(Exception):
    def __init__(self, code: int, message: str) -> None:
        super().__init__(f"CQL error 0x{code:04X}: {message}")
        self.code = code


# ---- primitive readers/writers ------------------------------------------


class _Buf:
    """Cursor over a response body."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise CQLError(0, "truncated frame body")
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def string(self) -> str:
        return self.take(self.u16()).decode("utf-8")

    def long_string(self) -> str:
        return self.take(self.i32()).decode("utf-8")

    def bytes_(self) -> bytes | None:
        n = self.i32()
        return None if n < 0 else self.take(n)

    def short_bytes(self) -> bytes:
        return self.take(self.u16())


def _string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


def _long_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">i", len(b)) + b


def _bytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def _string_map(m: Mapping[str, str]) -> bytes:
    out = struct.pack(">H", len(m))
    for k, v in m.items():
        out += _string(k) + _string(v)
    return out


# ---- type options --------------------------------------------------------


def read_type(buf: _Buf):
    """Parse one type [option] -> a descriptor tuple.

    ('vector', dim) for Cassandra 5 VectorType customs, ('map', kt, vt),
    ('list', et) / ('set', et), or (type_id,) for primitives."""
    tid = buf.u16()
    if tid == TYPE_CUSTOM:
        cls = buf.string()
        if cls.startswith(_VECTOR_MARSHAL):
            inner = cls[len(_VECTOR_MARSHAL) + 1 : -1]  # "(FloatType, n)"
            dim = int(inner.rsplit(",", 1)[1].strip())
            return ("vector", dim)
        return ("custom", cls)
    if tid == TYPE_MAP:
        return ("map", read_type(buf), read_type(buf))
    if tid in (TYPE_LIST, TYPE_SET):
        return ("list", read_type(buf))
    return (tid,)


def decode_value(t, data: bytes | None):
    if data is None:
        return None
    if t[0] == "vector":
        return np.frombuffer(data, dtype=">f4").astype(np.float32)
    if t[0] == "custom":
        return data
    if t[0] == "map":
        buf = _Buf(data)
        n = buf.i32()
        out = {}
        for _ in range(n):
            k = decode_value(t[1], buf.bytes_())
            v = decode_value(t[2], buf.bytes_())
            out[k] = v
        return out
    if t[0] == "list":
        buf = _Buf(data)
        n = buf.i32()
        return [decode_value(t[1], buf.bytes_()) for _ in range(n)]
    tid = t[0]
    if tid in (TYPE_VARCHAR, TYPE_ASCII):
        return data.decode("utf-8")
    if tid == TYPE_INT:
        return struct.unpack(">i", data)[0]
    if tid in (TYPE_BIGINT, TYPE_COUNTER):
        return struct.unpack(">q", data)[0]
    if tid == TYPE_FLOAT:
        return struct.unpack(">f", data)[0]
    if tid == TYPE_DOUBLE:
        return struct.unpack(">d", data)[0]
    if tid == TYPE_BOOLEAN:
        return data != b"\x00"
    raise CQLError(0, f"unsupported result type 0x{tid:04X}")


def encode_value(t, value) -> bytes | None:
    if value is None:
        return None
    if t[0] == "vector":
        arr = np.asarray(value, dtype=np.float32)
        if arr.size != t[1]:
            raise CQLError(0, f"vector dim {arr.size} != column dim {t[1]}")
        return arr.astype(">f4").tobytes()
    if t[0] == "map":
        out = struct.pack(">i", len(value))
        for k, v in value.items():
            out += _bytes(encode_value(t[1], k)) + _bytes(encode_value(t[2], v))
        return out
    if t[0] == "list":
        out = struct.pack(">i", len(value))
        for v in value:
            out += _bytes(encode_value(t[1], v))
        return out
    tid = t[0]
    if tid in (TYPE_VARCHAR, TYPE_ASCII):
        return str(value).encode("utf-8")
    if tid == TYPE_INT:
        return struct.pack(">i", int(value))
    if tid in (TYPE_BIGINT, TYPE_COUNTER):
        return struct.pack(">q", int(value))
    if tid == TYPE_FLOAT:
        return struct.pack(">f", float(value))
    if tid == TYPE_DOUBLE:
        return struct.pack(">d", float(value))
    if tid == TYPE_BOOLEAN:
        return b"\x01" if value else b"\x00"
    raise CQLError(0, f"unsupported bind type 0x{tid:04X}")


# ---- CQL literal interpolation (simple statements) -----------------------


def cql_literal(value) -> str:
    """Render one value as a CQL literal — the client-side %s substitution
    the DataStax driver applies to simple (unprepared) statements."""
    if value is None:
        return "NULL"
    if isinstance(value, str):
        return "'" + value.replace("'", "''") + "'"
    if isinstance(value, bool):
        return "true" if value else "false"
    # numpy scalars BEFORE (int, float): np.float64 subclasses float but
    # its numpy-2.x repr ("np.float64(1.5)") is not a CQL literal
    if isinstance(value, np.integer):
        return repr(int(value))
    if isinstance(value, np.floating):
        return repr(float(value))
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, Mapping):
        items = ", ".join(f"{cql_literal(k)}: {cql_literal(v)}" for k, v in value.items())
        return "{" + items + "}"
    if isinstance(value, np.ndarray):  # vector columns: always float elements
        return "[" + ", ".join(repr(float(x)) for x in value.reshape(-1)) + "]"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(cql_literal(x) for x in value) + "]"
    raise TypeError(f"no CQL literal form for {type(value)!r}")


def interpolate(cql: str, params: Sequence | None) -> str:
    """Substitute ``%s`` placeholders with CQL literals by a quote-aware
    token scan — NOT Python %-formatting.  ``%`` (and even ``%s``) inside
    a ``'...'`` string literal passes through untouched (``''`` is the CQL
    escaped quote and stays inside the literal), so statements like
    ``LIKE '%sql%'`` never raise or splice params into the literal."""
    params = () if params is None else params
    out: list[str] = []
    it = iter(params)
    used = 0
    i, n = 0, len(cql)
    in_str = False
    while i < n:
        ch = cql[i]
        if in_str:
            if ch == "'":
                if i + 1 < n and cql[i + 1] == "'":  # escaped quote ''
                    out.append("''")
                    i += 2
                    continue
                in_str = False
            out.append(ch)
            i += 1
        elif ch == "'":
            in_str = True
            out.append(ch)
            i += 1
        elif ch == "%" and i + 1 < n and cql[i + 1] == "s":
            try:
                out.append(cql_literal(next(it)))
            except StopIteration:
                raise ValueError(
                    f"statement has more %s placeholders than the {len(params)} params"
                ) from None
            used += 1
            i += 2
        else:
            out.append(ch)
            i += 1
    if used != len(params):
        raise ValueError(f"statement has {used} %s placeholders, got {len(params)} params")
    return "".join(out)


# ---- rows ----------------------------------------------------------------


class Row:
    """Attribute access over one result row (r.row_id, r.metadata_s, ...)."""

    def __init__(self, names: list[str], values: list) -> None:
        self.__dict__.update(zip(names, values))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Row({self.__dict__!r})"


class ResultSet:
    def __init__(self, rows: list[Row]) -> None:
        self._rows = rows

    def __iter__(self) -> Iterator[Row]:
        return iter(self._rows)

    def __len__(self) -> int:
        return len(self._rows)

    def one(self) -> Row | None:
        return self._rows[0] if self._rows else None


class PreparedStatement:
    def __init__(self, query_id: bytes, bind_types: list, cql: str = "") -> None:
        self.query_id = query_id
        self.bind_types = bind_types
        self.cql = cql  # kept for transparent re-prepare after reconnect


# ---- the client ----------------------------------------------------------


class CQLSession:
    """One authenticated connection with transparent reconnect.  A dropped
    TCP connection (server restart, idle LB reap, timeout mid-frame) is
    re-established on the next request and the request retried once —
    every statement this store issues is idempotent (row_id-keyed upserts,
    reads, deletes), so a replay after an ambiguous failure is safe.  The
    DataStax driver's pool did this transparently; a long-lived serving
    process must not need a restart to outlive its Cassandra pod.

    Thread-safe: a lock serializes request/response exchanges (store
    access is coarse-grained — batch upserts and single queries — so one
    connection suffices)."""

    def __init__(
        self,
        host: str,
        port: int = 9042,
        username: str = "cassandra",
        password: str = "cassandra",
        timeout: float = 10.0,
    ) -> None:
        self._addr = (host, port)
        self._auth = (username, password)
        self._timeout = timeout
        self._lock = threading.Lock()
        self._stream = 0
        self._sock: socket.socket | None = None
        with self._lock:
            self._connect_locked()

    def _connect_locked(self) -> None:
        """(Re)establish the socket + STARTUP/auth handshake.  Caller holds
        the lock; handshake frames bypass ``_request`` so a handshake
        failure is terminal, never retried into a loop."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:  # pragma: no cover
                pass
        self._sock = socket.create_connection(self._addr, timeout=self._timeout)
        op, resp = self._exchange_locked(OP_STARTUP, _string_map({"CQL_VERSION": "3.0.0"}))
        if op == OP_AUTHENTICATE:
            resp.string()  # authenticator class name
            user, password = self._auth
            token = b"\x00" + user.encode() + b"\x00" + password.encode()
            op, resp = self._exchange_locked(OP_AUTH_RESPONSE, _bytes(token))
            if op not in (OP_AUTH_SUCCESS, OP_READY):
                raise CQLError(0, f"authentication failed (opcode 0x{op:02X})")
        elif op != OP_READY:
            raise CQLError(0, f"unexpected STARTUP reply opcode 0x{op:02X}")

    # -- framing --

    def _exchange_locked(self, opcode: int, body: bytes) -> tuple[int, _Buf]:
        """One request/response on the current socket; caller holds the lock."""
        self._stream = (self._stream + 1) % 32768
        header = struct.pack(
            ">BBhBi", VERSION_REQ, 0, self._stream, opcode, len(body)
        )
        self._sock.sendall(header + body)
        raw = self._recv_exact(9)
        version, _flags, _stream, op, length = struct.unpack(">BBhBi", raw)
        if version != VERSION_RESP:
            raise CQLError(0, f"bad response version 0x{version:02X}")
        payload = self._recv_exact(length) if length else b""
        buf = _Buf(payload)
        if op == OP_ERROR:
            code = buf.i32()
            raise CQLError(code, buf.string())
        return op, buf

    def _request(
        self, opcode: int, body: bytes, idempotent: bool = True
    ) -> tuple[int, _Buf]:
        """One exchange with reconnect-and-replay on a dead socket.  Replay
        after an ambiguous failure (the request may already have applied
        server-side) is gated on ``idempotent`` — every statement this
        store issues is row_id-keyed upsert/read/delete so callers default
        to True; a future non-idempotent statement (counter update,
        non-keyed insert) must pass ``idempotent=False`` through
        ``execute`` and handle the reconnect error itself."""
        with self._lock:
            try:
                # ``cql.exchange`` injection seam — inside the try so an
                # injected failure exercises the same reconnect/replay
                # branches a real dead socket does.  Sits here rather than
                # in _exchange_locked so the STARTUP/auth handshake stays
                # fault-free (handshake failures are deliberately terminal).
                if fire_sync("cql.exchange"):
                    raise InjectedFault("injected drop at cql.exchange")
                return self._exchange_locked(opcode, body)
            except OSError:
                # dead/misaligned socket: reconnect; replay only if safe
                self._connect_locked()
                if not idempotent:
                    raise
                return self._exchange_locked(opcode, body)
            except CQLError as exc:
                if exc.code == 0 and "connection closed" in str(exc):
                    self._connect_locked()
                    if not idempotent:
                        raise
                    return self._exchange_locked(opcode, body)
                raise

    def _recv_exact(self, n: int) -> bytes:
        # into one buffer: ``out += chunk`` copies the frame once a chunk,
        # quadratic in a seed read's tens of MB
        out = bytearray(n)
        view = memoryview(out)
        got = 0
        while got < n:
            k = self._sock.recv_into(view[got:])
            if not k:
                raise CQLError(0, "connection closed by server")
            got += k
        return bytes(out)

    # -- public API --

    def execute(
        self, query, params: Sequence | None = None, idempotent: bool = True
    ) -> ResultSet:
        if isinstance(query, PreparedStatement):
            return self._execute_prepared(query, params or (), idempotent=idempotent)
        cql = interpolate(query, params)
        body = _long_string(cql) + struct.pack(">HB", CONSISTENCY_ONE, 0)
        op, buf = self._request(OP_QUERY, body, idempotent=idempotent)
        return self._parse_result(op, buf)

    def prepare(self, cql: str) -> PreparedStatement:
        op, buf = self._request(OP_PREPARE, _long_string(cql))
        kind = buf.i32()
        if kind != RESULT_PREPARED:
            raise CQLError(0, f"PREPARE returned result kind {kind}")
        query_id = buf.short_bytes()
        # metadata: <flags><columns_count><pk_count>[<pk_index>...]
        flags = buf.i32()
        n_cols = buf.i32()
        pk_count = buf.i32()
        for _ in range(pk_count):
            buf.u16()
        global_spec = flags & 0x0001
        if global_spec and n_cols:
            buf.string(), buf.string()  # keyspace, table
        bind_types = []
        for _ in range(n_cols):
            if not global_spec:
                buf.string(), buf.string()
            buf.string()  # column name
            bind_types.append(read_type(buf))
        return PreparedStatement(query_id, bind_types, cql)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass

    # -- internals --

    def _execute_prepared(
        self, stmt: PreparedStatement, params: Sequence, idempotent: bool = True
    ) -> ResultSet:
        if len(params) != len(stmt.bind_types):
            raise CQLError(
                0, f"bound {len(params)} values to {len(stmt.bind_types)} markers"
            )
        values = b"".join(
            _bytes(encode_value(t, v)) for t, v in zip(stmt.bind_types, params)
        )
        body = (
            struct.pack(">H", len(stmt.query_id)) + stmt.query_id
            + struct.pack(">HB", CONSISTENCY_ONE, 0x01)  # flag 0x01: values
            + struct.pack(">H", len(params)) + values
        )
        try:
            op, buf = self._request(OP_EXECUTE, body, idempotent=idempotent)
        except CQLError as exc:
            # UNPREPARED: the (possibly restarted) node lost this statement
            # — re-prepare in place and retry ONCE (no recursion: a second
            # UNPREPARED right after a successful PREPARE is a server bug)
            if exc.code != 0x2500 or not stmt.cql:
                raise
            fresh = self.prepare(stmt.cql)
            stmt.query_id, stmt.bind_types = fresh.query_id, fresh.bind_types
            body = (
                struct.pack(">H", len(stmt.query_id)) + stmt.query_id
                + struct.pack(">HB", CONSISTENCY_ONE, 0x01)
                + struct.pack(">H", len(params)) + values
            )
            op, buf = self._request(OP_EXECUTE, body, idempotent=idempotent)
        return self._parse_result(op, buf)

    def _parse_result(self, op: int, buf: _Buf) -> ResultSet:
        if op != OP_RESULT:
            raise CQLError(0, f"unexpected result opcode 0x{op:02X}")
        kind = buf.i32()
        if kind in (RESULT_VOID, RESULT_SET_KEYSPACE, RESULT_SCHEMA_CHANGE):
            return ResultSet([])
        if kind != RESULT_ROWS:
            raise CQLError(0, f"unsupported result kind {kind}")
        flags = buf.i32()
        n_cols = buf.i32()
        if flags & 0x0002:  # has_more_pages: paging_state present
            buf.bytes_()
        global_spec = flags & 0x0001
        if global_spec:
            buf.string(), buf.string()
        names: list[str] = []
        types: list = []
        no_metadata = flags & 0x0004
        if not no_metadata:
            for _ in range(n_cols):
                if not global_spec:
                    buf.string(), buf.string()
                names.append(buf.string())
                types.append(read_type(buf))
        n_rows = buf.i32()
        rows = []
        for _ in range(n_rows):
            values = [decode_value(types[c], buf.bytes_()) for c in range(n_cols)]
            rows.append(Row(names, values))
        return ResultSet(rows)


class CQLCluster:
    """Contact-point fan-out matching the driver surface the store builds
    (cassandra_service.py:130-160): try each host, first to connect wins."""

    def __init__(
        self,
        contact_points: list[str],
        port: int = 9042,
        username: str = "cassandra",
        password: str = "cassandra",
    ) -> None:
        self._hosts = contact_points
        self._port = port
        self._user = username
        self._password = password

    def connect(self) -> CQLSession:
        err: Exception | None = None
        for host in self._hosts:
            try:
                return CQLSession(host, self._port, self._user, self._password)
            except (OSError, CQLError) as exc:  # pragma: no cover - multi-host
                err = exc
        raise err or OSError("no Cassandra contact points")
