"""rosbag2 (sqlite3) reading/writing without ROS (a copy of
``sonar_3d_reconstruction_tpu.io.bag``, so the port never imports the JAX
package).

The reference replays recorded experiments with ``ros2 bag play`` (reference
launch/3d_mapping.launch.py:167-171; the KIRO water-tank dataset,
config/3d_mapper.yaml:83).  This module reads the same bag format directly:
the rosbag2 sqlite3 schema (``topics`` + ``messages`` tables) and CDR
(XCDR1) deserialization of the two message types the mapper consumes —
``sensor_msgs/msg/Image`` and ``nav_msgs/msg/Odometry``.

A writer for the same subset doubles as the synthetic-fixture generator the
test suite uses in place of the (unavailable) KIRO dataset (SURVEY.md 4d).
"""

from __future__ import annotations

import sqlite3
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

IMAGE_TYPE = "sensor_msgs/msg/Image"
ODOMETRY_TYPE = "nav_msgs/msg/Odometry"

# ---------------------------------------------------------------------------
# CDR (XCDR1, little-endian) primitives
# ---------------------------------------------------------------------------


class _CdrReader:
    """Little-endian XCDR1 reader. Alignment is relative to the payload start
    (byte 4 of the serialized blob, after the encapsulation header)."""

    def __init__(self, data: bytes):
        assert len(data) >= 4, "truncated CDR blob"
        # encapsulation: {representation id, options}; 0x0001 = CDR_LE
        assert data[1] in (0x00, 0x01), f"unsupported CDR representation {data[:2]!r}"
        self.little = data[1] == 0x01
        self.buf = memoryview(data)[4:]
        self.pos = 0

    def _align(self, size: int) -> None:
        rem = self.pos % size
        if rem:
            self.pos += size - rem

    def _unpack(self, fmt: str, size: int):
        self._align(size)
        (v,) = struct.unpack_from(("<" if self.little else ">") + fmt, self.buf, self.pos)
        self.pos += size
        return v

    def uint8(self) -> int:
        return self._unpack("B", 1)

    def int32(self) -> int:
        return self._unpack("i", 4)

    def uint32(self) -> int:
        return self._unpack("I", 4)

    def float64(self) -> float:
        return self._unpack("d", 8)

    def string(self) -> str:
        n = self.uint32()  # length INCLUDING the null terminator
        s = bytes(self.buf[self.pos : self.pos + n - 1]).decode("utf-8")
        self.pos += n
        return s

    def bytes_seq(self) -> bytes:
        n = self.uint32()
        b = bytes(self.buf[self.pos : self.pos + n])
        self.pos += n
        return b

    def float64_array(self, n: int) -> np.ndarray:
        self._align(8)
        out = np.frombuffer(self.buf, "<f8" if self.little else ">f8",
                            count=n, offset=self.pos)
        self.pos += 8 * n
        return out


class _CdrWriter:
    def __init__(self) -> None:
        self.chunks: List[bytes] = [b"\x00\x01\x00\x00"]  # CDR_LE
        self.pos = 0

    def _align(self, size: int) -> None:
        rem = self.pos % size
        if rem:
            pad = size - rem
            self.chunks.append(b"\x00" * pad)
            self.pos += pad

    def _pack(self, fmt: str, size: int, v) -> None:
        self._align(size)
        self.chunks.append(struct.pack("<" + fmt, v))
        self.pos += size

    def uint8(self, v: int) -> None:
        self._pack("B", 1, v)

    def int32(self, v: int) -> None:
        self._pack("i", 4, v)

    def uint32(self, v: int) -> None:
        self._pack("I", 4, v)

    def float64(self, v: float) -> None:
        self._pack("d", 8, v)

    def string(self, s: str) -> None:
        b = s.encode("utf-8") + b"\x00"
        self.uint32(len(b))
        self.chunks.append(b)
        self.pos += len(b)

    def bytes_seq(self, b: bytes) -> None:
        self.uint32(len(b))
        self.chunks.append(bytes(b))
        self.pos += len(b)

    def float64_array(self, arr) -> None:
        self._align(8)
        b = np.asarray(arr, "<f8").tobytes()
        self.chunks.append(b)
        self.pos += len(b)

    def getvalue(self) -> bytes:
        return b"".join(self.chunks)


# ---------------------------------------------------------------------------
# Message (de)serialization — exactly the fields the mapper consumes
# ---------------------------------------------------------------------------


@dataclass
class ImageMsg:
    stamp: float            # header.stamp as float seconds
    frame_id: str
    height: int
    width: int
    encoding: str
    is_bigendian: bool
    step: int
    data: bytes


@dataclass
class OdometryMsg:
    stamp: float
    frame_id: str
    child_frame_id: str
    position: np.ndarray      # (3,)
    orientation: np.ndarray   # (4,) xyzw
    pose_covariance: np.ndarray = field(
        default_factory=lambda: np.zeros(36)
    )


def _read_header(r: _CdrReader) -> Tuple[float, str]:
    sec, nsec = r.int32(), r.uint32()
    return sec + nsec * 1e-9, r.string()


def _write_header(w: _CdrWriter, stamp: float, frame_id: str) -> None:
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    if nsec >= 1_000_000_000:
        sec, nsec = sec + 1, nsec - 1_000_000_000
    w.int32(sec)
    w.uint32(nsec)
    w.string(frame_id)


def decode_image_msg(blob: bytes) -> ImageMsg:
    r = _CdrReader(blob)
    stamp, frame_id = _read_header(r)
    height, width = r.uint32(), r.uint32()
    encoding = r.string()
    is_bigendian = bool(r.uint8())
    step = r.uint32()
    data = r.bytes_seq()
    return ImageMsg(stamp, frame_id, height, width, encoding, is_bigendian, step, data)


def encode_image_msg(m: ImageMsg) -> bytes:
    w = _CdrWriter()
    _write_header(w, m.stamp, m.frame_id)
    w.uint32(m.height)
    w.uint32(m.width)
    w.string(m.encoding)
    w.uint8(1 if m.is_bigendian else 0)
    w.uint32(m.step)
    w.bytes_seq(m.data)
    return w.getvalue()


def decode_odometry_msg(blob: bytes) -> OdometryMsg:
    r = _CdrReader(blob)
    stamp, frame_id = _read_header(r)
    child = r.string()
    pos = np.array([r.float64(), r.float64(), r.float64()])
    quat = np.array([r.float64(), r.float64(), r.float64(), r.float64()])
    cov = r.float64_array(36).copy()
    # twist follows; the mapper ignores it (reference node:319-330 reads pose only)
    return OdometryMsg(stamp, frame_id, child, pos, quat, cov)


def encode_odometry_msg(m: OdometryMsg) -> bytes:
    w = _CdrWriter()
    _write_header(w, m.stamp, m.frame_id)
    w.string(m.child_frame_id)
    for v in m.position:
        w.float64(float(v))
    for v in m.orientation:
        w.float64(float(v))
    w.float64_array(m.pose_covariance)
    # twist: zero linear+angular + zero covariance
    w.float64_array(np.zeros(6))
    w.float64_array(np.zeros(36))
    return w.getvalue()


# ---------------------------------------------------------------------------
# rosbag2 sqlite3 container
# ---------------------------------------------------------------------------


class BagReader:
    """Reads Image / Odometry messages from a rosbag2 ``.db3`` file."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        self.topics: Dict[int, Tuple[str, str]] = {}
        for tid, name, typ in self.conn.execute(
            "SELECT id, name, type FROM topics"
        ):
            self.topics[tid] = (name, typ)

    def topic_names(self) -> Dict[str, str]:
        return {name: typ for name, typ in self.topics.values()}

    def raw_messages(
        self, topic_names: Optional[List[str]] = None
    ) -> Iterator[Tuple[str, str, float, bytes]]:
        """Yield (topic, type, bag_timestamp_sec, cdr_blob) in time order
        (Image/Odometry topics only) — the batch-decode feed (io/native.py)
        and McapReader API twin."""
        wanted = {
            tid: (name, typ)
            for tid, (name, typ) in self.topics.items()
            if (topic_names is None or name in topic_names)
            and typ in (IMAGE_TYPE, ODOMETRY_TYPE)
        }
        if not wanted:
            return
        placeholders = ",".join("?" * len(wanted))
        for tid, ts, blob in self.conn.execute(
            f"SELECT topic_id, timestamp, data FROM messages "
            f"WHERE topic_id IN ({placeholders}) ORDER BY timestamp",
            list(wanted),
        ):
            name, typ = wanted[tid]
            yield name, typ, ts * 1e-9, blob

    def messages(
        self, topic_names: Optional[List[str]] = None
    ) -> Iterator[Tuple[str, float, object]]:
        """Yield (topic, bag_timestamp_sec, decoded_msg) in time order.
        Only Image/Odometry topics are decoded; others are skipped."""
        for name, typ, ts, blob in self.raw_messages(topic_names):
            msg = (
                decode_image_msg(blob)
                if typ == IMAGE_TYPE
                else decode_odometry_msg(blob)
            )
            yield name, ts, msg

    def close(self) -> None:
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# rosbag2 QoS YAML for a sensor-style topic (what `ros2 bag record`
# captures from BEST_EFFORT/KEEP_LAST publishers, reference node:184-189);
# readers only require the column to exist, but real tooling shows it
_QOS_SENSOR_YAML = (
    "- history: 3\n  depth: 0\n  reliability: 2\n  durability: 2\n"
    "  deadline:\n    sec: 9223372036\n    nsec: 854775807\n"
    "  lifespan:\n    sec: 9223372036\n    nsec: 854775807\n"
    "  liveliness: 1\n  liveliness_lease_duration:\n    sec: 9223372036\n"
    "    nsec: 854775807\n  avoid_ros_namespace_conventions: false"
)


class BagWriter:
    """Writes a rosbag2-Humble-schema ``.db3`` (fixtures, recordings).

    Emits the full storage layout `rosbag2_storage` (Humble, schema v3)
    creates — ``schema`` + ``metadata`` tables, QoS-bearing ``topics``, the
    ``timestamp_idx`` index — so ROS2 tooling (``ros2 bag info/play``) can
    consume bags this framework records, not only the other way around.
    """

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        c = self.conn
        c.execute(
            "CREATE TABLE schema(schema_version INTEGER PRIMARY KEY, "
            "ros_distro TEXT NOT NULL)"
        )
        c.execute("INSERT INTO schema VALUES (3, 'humble')")
        c.execute(
            "CREATE TABLE metadata(id INTEGER PRIMARY KEY, "
            "metadata_version INTEGER NOT NULL, metadata TEXT NOT NULL)"
        )
        c.execute(
            "CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT NOT NULL, "
            "type TEXT NOT NULL, serialization_format TEXT NOT NULL, "
            "offered_qos_profiles TEXT NOT NULL)"
        )
        c.execute(
            "CREATE TABLE messages(id INTEGER PRIMARY KEY, "
            "topic_id INTEGER NOT NULL, timestamp INTEGER NOT NULL, "
            "data BLOB NOT NULL)"
        )
        c.execute("CREATE INDEX timestamp_idx ON messages (timestamp ASC)")
        self._topic_ids: Dict[str, int] = {}
        self._topic_types: Dict[str, str] = {}
        self._counts: Dict[str, int] = {}
        self._t_min: Optional[int] = None
        self._t_max = 0
        self._closed = False

    def add_topic(self, name: str, typ: str) -> int:
        if name in self._topic_ids:  # idempotent (see McapWriter.add_topic)
            return self._topic_ids[name]
        tid = len(self._topic_ids) + 1
        self.conn.execute(
            "INSERT INTO topics VALUES (?, ?, ?, 'cdr', ?)",
            (tid, name, typ, _QOS_SENSOR_YAML),
        )
        self._topic_ids[name] = tid
        self._topic_types[name] = typ
        self._counts[name] = 0
        return tid

    def write(self, topic: str, stamp_sec: float, msg) -> None:
        blob = (
            encode_image_msg(msg)
            if isinstance(msg, ImageMsg)
            else encode_odometry_msg(msg)
        )
        t_ns = int(round(stamp_sec * 1e9))
        self.conn.execute(
            "INSERT INTO messages(topic_id, timestamp, data) VALUES (?, ?, ?)",
            (self._topic_ids[topic], t_ns, blob),
        )
        self._counts[topic] += 1
        self._t_min = t_ns if self._t_min is None else min(self._t_min, t_ns)
        self._t_max = max(self._t_max, t_ns)

    def close(self) -> None:
        if self._closed:  # idempotent: with-block + explicit close
            return
        self._closed = True
        # rosbag2_bagfile_information blob (metadata_version 5) — `ros2 bag
        # info` reads this; keys/structure per rosbag2_storage's YAML
        t0 = self._t_min or 0
        topics_yaml = "".join(
            "  - topic_metadata:\n"
            f"      name: {name}\n"
            f"      type: {self._topic_types[name]}\n"
            "      serialization_format: cdr\n"
            f"    message_count: {self._counts[name]}\n"
            for name in self._topic_ids
        )
        meta = (
            "rosbag2_bagfile_information:\n"
            "  version: 5\n"
            "  storage_identifier: sqlite3\n"
            f"  duration:\n    nanoseconds: {self._t_max - t0}\n"
            f"  starting_time:\n    nanoseconds_since_epoch: {t0}\n"
            f"  message_count: {sum(self._counts.values())}\n"
            "  topics_with_message_count:\n"
            f"{topics_yaml}"
            "  compression_format: \"\"\n  compression_mode: \"\"\n"
        )
        self.conn.execute(
            "INSERT INTO metadata(metadata_version, metadata) VALUES (5, ?)",
            (meta,),
        )
        self.conn.commit()
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_bag_sequence(
    path: str,
    sonar_topic: str = "/sensor/sonar/oculus/m750d/image",
    odometry_topic: str = "/fast_lio/odometry",
    slop: float = 0.1,
    use_native: bool = True,
):
    """Offline fast path: whole bag -> time-paired dense arrays.

    Returns (images (P, R, B) uint8, positions (P, 3), quaternions (P, 4),
    stamps (P,)).  Accepts .db3 sqlite or .mcap containers (sniffed by
    magic).  Uses the native batch CDR decoder + pairing (io/native.py) when
    available; pure-Python fallback otherwise.  All images must share one
    geometry (true for a fixed sonar)."""
    img_blobs: List[bytes] = []
    odo_blobs: List[bytes] = []
    from sonar_3d_reconstruction_tpu_torch.io.mcap import MAGIC as _MCAP_MAGIC

    with open(path, "rb") as f:
        is_mcap = f.read(len(_MCAP_MAGIC)) == _MCAP_MAGIC
    if is_mcap:
        from sonar_3d_reconstruction_tpu_torch.io.mcap import McapReader

        img_t: List[Tuple[float, bytes]] = []
        odo_t: List[Tuple[float, bytes]] = []
        with McapReader(path) as r:
            for topic, typ, ts, blob in r.raw_messages(
                [sonar_topic, odometry_topic]
            ):
                if topic == sonar_topic and typ == IMAGE_TYPE:
                    img_t.append((ts, blob))
                elif topic == odometry_topic and typ == ODOMETRY_TYPE:
                    odo_t.append((ts, blob))
        # mcap chunks may be grouped per channel / out of log-time order;
        # the pairing backends require sorted streams
        img_blobs = [b for _, b in sorted(img_t, key=lambda x: x[0])]
        odo_blobs = [b for _, b in sorted(odo_t, key=lambda x: x[0])]
        if not img_blobs or not odo_blobs:
            # same precise diagnosability as the sqlite branch: name the
            # missing topic/type and what the file actually holds
            available = r.topic_names()
            for want, typ_want in (
                (sonar_topic, IMAGE_TYPE), (odometry_topic, ODOMETRY_TYPE),
            ):
                if available.get(want) != typ_want:
                    raise ValueError(
                        f"topic {want!r} ({typ_want}) not in {path}; "
                        f"available: {available}"
                    )
    else:
        conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        topic_ids = {
            name: (tid, typ)
            for tid, name, typ in conn.execute(
                "SELECT id, name, type FROM topics"
            )
        }
        for want, typ_want, sink in (
            (sonar_topic, IMAGE_TYPE, img_blobs),
            (odometry_topic, ODOMETRY_TYPE, odo_blobs),
        ):
            if want not in topic_ids or topic_ids[want][1] != typ_want:
                raise ValueError(f"topic {want!r} ({typ_want}) not in {path}")
            tid = topic_ids[want][0]
            for (blob,) in conn.execute(
                "SELECT data FROM messages WHERE topic_id=? ORDER BY timestamp",
                (tid,),
            ):
                sink.append(blob)
        conn.close()
    if not img_blobs or not odo_blobs:
        raise ValueError(f"no messages for the requested topics in {path}")

    head = decode_image_msg(img_blobs[0])
    height, width = head.height, head.width

    native_ok = False
    if use_native:
        from sonar_3d_reconstruction_tpu_torch.io import native

        native_ok = native.available()
    if native_ok:
        from sonar_3d_reconstruction_tpu_torch.io import native

        img_stamps, images = native.image_decode_batch(img_blobs, height, width)
        odo_stamps, positions, quats = native.odometry_decode_batch(odo_blobs)
        pairs = native.pair_streams(img_stamps, odo_stamps, slop)
    else:
        from sonar_3d_reconstruction_tpu_torch.io.image import decode_image
        from sonar_3d_reconstruction_tpu_torch.io.timesync import pair_streams

        imgs, img_stamps = [], []
        for b in img_blobs:
            m = decode_image_msg(b)
            imgs.append(
                decode_image(m.data, m.height, m.width, m.encoding, m.step,
                             m.is_bigendian)
            )
            img_stamps.append(m.stamp)
        images = np.stack(imgs)
        img_stamps = np.asarray(img_stamps)
        odos = [decode_odometry_msg(b) for b in odo_blobs]
        odo_stamps = np.asarray([m.stamp for m in odos])
        positions = np.stack([m.position for m in odos])
        quats = np.stack([m.orientation for m in odos])
        pairs = pair_streams(img_stamps, odo_stamps, slop)

    pi = np.asarray([p for p, _ in pairs], np.int64)
    qi = np.asarray([q for _, q in pairs], np.int64)
    return images[pi], positions[qi], quats[qi], np.asarray(img_stamps)[pi]


def write_synthetic_bag(
    path: str,
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    *,
    sonar_topic: str = "/sensor/sonar/oculus/m750d/image",
    odometry_topic: str = "/fast_lio/odometry",
    rate_hz: float = 2.0,
    t0: float = 1_700_000_000.0,
    odom_jitter: float = 0.0,
) -> None:
    """Synthetic KIRO-style recording: paired Image + Odometry streams.

    The container follows the extension: ``.mcap`` writes an mcap file
    (zstd-chunked when the native codec is available, rosbag2's default
    recording format), anything else the sqlite3 ``.db3`` layout."""
    n = len(images)
    if path.endswith(".mcap"):
        from sonar_3d_reconstruction_tpu_torch.io import native
        from sonar_3d_reconstruction_tpu_torch.io.mcap import McapWriter

        compression = "store"
        for name in ("zstd", "lz4"):
            if native.available() and native.codec_available(name):
                compression = name
                break
        writer = McapWriter(path, chunk_compression=compression)
    else:
        writer = BagWriter(path)
    with writer as w:
        w.add_topic(sonar_topic, IMAGE_TYPE)
        w.add_topic(odometry_topic, ODOMETRY_TYPE)
        rng = np.random.default_rng(0)
        for i in range(n):
            t = t0 + i / rate_hz
            img = np.ascontiguousarray(images[i], dtype=np.uint8)
            w.write(
                sonar_topic,
                t,
                ImageMsg(
                    stamp=t,
                    frame_id="sonar_link",
                    height=img.shape[0],
                    width=img.shape[1],
                    encoding="mono8",
                    is_bigendian=False,
                    step=img.shape[1],
                    data=img.tobytes(),
                ),
            )
            dt = float(rng.uniform(-odom_jitter, odom_jitter)) if odom_jitter else 0.0
            w.write(
                odometry_topic,
                t + dt,
                OdometryMsg(
                    stamp=t + dt,
                    frame_id="camera_init",
                    child_frame_id="body",
                    position=np.asarray(positions[i], np.float64),
                    orientation=np.asarray(quaternions[i], np.float64),
                ),
            )
