"""Bag-format record/replay: rosbag2-layout sqlite3 and mcap containers.

The reference reconstructs full MPC I/O from rosbag2 files with
mcap/sqlite3 autodetection (`read_from_bag_trajectory.py:29-54` detects by
magic, `:57-196` rebuilds WeightedTrajectoryPoints and predictions).  This
module is the transport-free analog behind `MPCRecorder`'s npz interface:

- **sqlite3**: the exact rosbag2 database layout (`topics` +
  `messages(topic_id, timestamp, data BLOB)` tables) via the stdlib driver.
- **mcap**: a minimal spec-compliant writer/reader (magic, Header, Schema,
  Channel, Message, DataEnd, Footer records with opcode+length framing);
  unknown records are skipped on read, so files produced by real mcap
  writers parse at the container level.

Payloads are CDR-encapsulated (little-endian, the 4-byte representation
header rosbag2 uses) flat float64 arrays with a shape prefix — the
recorder's own schema; `load_bag` autodetects the container by magic like
the reference.

Port of the JAX package's `runtime/bag_readers.py` (numpy, sqlite3 and
struct only; kept as a copy so that reading a bag imports no JAX). The
files are byte for byte those of the JAX writer, the mcap header's library
field included, so either package reads the other's bags.
"""

from __future__ import annotations

import sqlite3
import struct
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import numpy as np

Record = Tuple[int, np.ndarray]  # (timestamp_ns, array)

_CDR_HEADER = b"\x00\x01\x00\x00"  # CDR_LE encapsulation
_MCAP_MAGIC = b"\x89MCAP0\r\n"


# ---------------------------------------------------------------------------
# CDR-encapsulated array payload
# ---------------------------------------------------------------------------

def _encode_payload(arr: np.ndarray) -> bytes:
    a = np.ascontiguousarray(arr, dtype=np.float64)
    dims = a.shape
    head = struct.pack("<I", len(dims)) + b"".join(
        struct.pack("<I", d) for d in dims)
    return _CDR_HEADER + head + struct.pack("<I", a.size) + a.tobytes()


def _decode_payload(data: bytes) -> np.ndarray:
    assert data[:4] == _CDR_HEADER, "not a CDR_LE payload"
    off = 4
    (ndim,) = struct.unpack_from("<I", data, off)
    off += 4
    dims = []
    for _ in range(ndim):
        (d,) = struct.unpack_from("<I", data, off)
        dims.append(d)
        off += 4
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    a = np.frombuffer(data, dtype="<f8", count=n, offset=off)
    return a.reshape(dims).copy()


# ---------------------------------------------------------------------------
# sqlite3 (rosbag2 database layout)
# ---------------------------------------------------------------------------

def write_sqlite_bag(path, topics: Dict[str, Iterable[Record]]) -> None:
    path = Path(path)
    if path.exists():
        path.unlink()
    con = sqlite3.connect(str(path))
    con.executescript(
        """
        CREATE TABLE topics(
            id INTEGER PRIMARY KEY, name TEXT NOT NULL, type TEXT NOT NULL,
            serialization_format TEXT NOT NULL,
            offered_qos_profiles TEXT NOT NULL);
        CREATE TABLE messages(
            id INTEGER PRIMARY KEY, topic_id INTEGER NOT NULL,
            timestamp INTEGER NOT NULL, data BLOB NOT NULL);
        """
    )
    for tid, (name, records) in enumerate(topics.items(), start=1):
        con.execute(
            "INSERT INTO topics VALUES (?, ?, ?, ?, ?)",
            (tid, name, "agimus_tpu/msg/FloatArray", "cdr", ""))
        con.executemany(
            "INSERT INTO messages(topic_id, timestamp, data) VALUES (?, ?, ?)",
            [(tid, int(ts), _encode_payload(arr)) for ts, arr in records])
    con.commit()
    con.close()


def read_sqlite_bag(path) -> Dict[str, List[Record]]:
    con = sqlite3.connect(str(Path(path)))
    names = {tid: name for tid, name in con.execute(
        "SELECT id, name FROM topics")}
    out: Dict[str, List[Record]] = {n: [] for n in names.values()}
    for tid, ts, data in con.execute(
            "SELECT topic_id, timestamp, data FROM messages ORDER BY id"):
        out[names[tid]].append((int(ts), _decode_payload(data)))
    con.close()
    return out


# ---------------------------------------------------------------------------
# mcap (minimal spec-compliant subset)
# ---------------------------------------------------------------------------

_OP_HEADER = 0x01
_OP_FOOTER = 0x02
_OP_SCHEMA = 0x03
_OP_CHANNEL = 0x04
_OP_MESSAGE = 0x05
_OP_CHUNK = 0x06
_OP_DATA_END = 0x0F


def _rec(op: int, body: bytes) -> bytes:
    return struct.pack("<BQ", op, len(body)) + body


def _pstr(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def write_mcap_bag(path, topics: Dict[str, Iterable[Record]]) -> None:
    with open(Path(path), "wb") as f:
        f.write(_MCAP_MAGIC)
        f.write(_rec(_OP_HEADER, _pstr("") + _pstr("agimus_controller_tpu")))
        f.write(_rec(_OP_SCHEMA, struct.pack("<H", 1)
                     + _pstr("agimus_tpu/msg/FloatArray") + _pstr("cdr")
                     + struct.pack("<I", 0)))
        for cid, (name, records) in enumerate(topics.items(), start=1):
            f.write(_rec(_OP_CHANNEL, struct.pack("<H", cid)
                         + struct.pack("<H", 1) + _pstr(name) + _pstr("cdr")
                         + struct.pack("<I", 0)))
            for seq, (ts, arr) in enumerate(records):
                body = struct.pack("<HIQQ", cid, seq, int(ts), int(ts))
                f.write(_rec(_OP_MESSAGE, body + _encode_payload(arr)))
        f.write(_rec(_OP_DATA_END, struct.pack("<I", 0)))
        f.write(_rec(_OP_FOOTER, struct.pack("<QQI", 0, 0, 0)))
        f.write(_MCAP_MAGIC)


def read_mcap_bag(path) -> Dict[str, List[Record]]:
    data = Path(path).read_bytes()
    assert data[:8] == _MCAP_MAGIC, "not an mcap file"
    channels: Dict[int, str] = {}
    out: Dict[str, List[Record]] = {}

    def parse_records(buf: bytes, start: int, end: int, top_level: bool):
        off = start
        while off < end:
            op, length = struct.unpack_from("<BQ", buf, off)
            off += 9
            body = buf[off:off + length]
            off += length
            if op == _OP_CHANNEL:
                cid, _schema = struct.unpack_from("<HH", body, 0)
                (nlen,) = struct.unpack_from("<I", body, 4)
                name = body[8:8 + nlen].decode()
                channels[cid] = name
                out.setdefault(name, [])
            elif op == _OP_MESSAGE:
                cid, _seq, ts, _pub = struct.unpack_from("<HIQQ", body, 0)
                payload = body[22:]
                out[channels[cid]].append(
                    (int(ts), _decode_payload(payload)))
            elif op == _OP_CHUNK:
                # real mcap writers store messages inside chunks by default
                # (ADVICE r03): 2x u64 times + u64 uncompressed_size +
                # u32 crc + compression string + u64 records size + records
                (clen,) = struct.unpack_from("<I", body, 28)
                compression = body[32:32 + clen].decode()
                (rlen,) = struct.unpack_from("<Q", body, 32 + clen)
                records = body[40 + clen:40 + clen + rlen]
                if compression == "":
                    pass
                elif compression == "zstd":
                    import zstandard  # optional; clear error if absent

                    records = zstandard.ZstdDecompressor().decompress(records)
                elif compression == "lz4":
                    import lz4.frame

                    records = lz4.frame.decompress(records)
                else:
                    raise ValueError(
                        f"unsupported mcap chunk compression {compression!r}")
                parse_records(records, 0, len(records), top_level=False)
            elif op == _OP_DATA_END or (top_level and op == _OP_FOOTER):
                break
            # other record kinds (statistics, indexes) are skipped

    parse_records(data, 8, len(data) - 8, top_level=True)
    return out


# ---------------------------------------------------------------------------
# autodetect + recorder-schema reconstruction (reference API analog)
# ---------------------------------------------------------------------------

def load_bag(path) -> Dict[str, List[Record]]:
    """Autodetect the container by magic (the reference's mcap/sqlite3
    sniffing, `read_from_bag_trajectory.py:29-54`)."""
    head = Path(path).read_bytes()[:16]
    if head[:8] == _MCAP_MAGIC:
        return read_mcap_bag(path)
    if head[:15] == b"SQLite format 3":
        return read_sqlite_bag(path)
    raise ValueError(f"unrecognized bag container: {path}")


def load_mpc_inputs_from_bag(path):
    """(time_ns [K], x0 [K, nx]) from the /ocp_x0 stream (the reference
    publishes x0 'to replay it offline', README.md:115-119)."""
    bag = load_bag(path)
    recs = bag.get("/ocp_x0", [])
    ts = np.asarray([t for t, _ in recs], dtype=np.int64)
    x0 = np.stack([a for _, a in recs]) if recs else np.zeros((0, 0))
    return ts, x0


def load_mpc_outputs_from_bag(path):
    """Predictions + solver telemetry from the /mpc_debug streams
    (reference `load_mpc_outputs_from_rosbag`,
    `read_from_bag_trajectory.py:102-188`)."""
    bag = load_bag(path)

    def stack(name):
        recs = bag.get(name, [])
        return np.stack([a for _, a in recs]) if recs else np.zeros((0,))

    out = {
        "state_predictions": stack("/mpc_debug/state_predictions"),
        "control_predictions": stack("/mpc_debug/control_predictions"),
        "kkt": stack("/mpc_debug/kkt").reshape(-1),
        "iters": stack("/mpc_debug/iters").reshape(-1),
        "qp_iters": stack("/mpc_debug/qp_iters").reshape(-1),
        "solve_time_ns": stack("/ocp_solve_time").reshape(-1),
    }
    # named per-cost streams (reference `<name>_residuals`/`<name>_references`,
    # `read_from_bag_trajectory.py:102-188`)
    for topic in bag:
        if topic.startswith("/mpc_debug/") and (
                topic.endswith("_references") or topic.endswith("_residuals")):
            out[topic[len("/mpc_debug/"):]] = stack(topic)
    return out
