"""TFRecord + tf.train.Example codec in pure Python (no TensorFlow).

Reads the RLDS/TFDS storage format the reference consumes through tf.data
(octo/data/dataset.py:426-479). Only the pieces RLDS needs are implemented:
TFRecord framing (length-prefixed records with masked crc32c) and the
Example proto (BytesList / packed FloatList / packed Int64List).

A C++ reader with the same interface lives in native/ for production
throughput; this module is the portable reference implementation and the
writer used by the RLDS->shard converter and tests.

The port's copy of hypervla_tpu/data/tfrecord.py: only its imports differ.
"""
import struct
from typing import Dict, Iterator, List, Union

import numpy as np

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def read_tfrecord(path: str, validate_crc: bool = False) -> Iterator[bytes]:
    """Yields raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if validate_crc:
                (crc,) = struct.unpack("<I", header[8:12])
                assert crc == _masked_crc(header[:8]), "corrupt length crc"
            data = f.read(length)
            footer = f.read(4)
            if validate_crc:
                (crc,) = struct.unpack("<I", footer)
                assert crc == _masked_crc(data), "corrupt data crc"
            yield data


def write_tfrecord(path: str, records) -> None:
    with open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


# ------------------------- protobuf wire primitives -------------------------


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _write_varint((field << 3) | wire)


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:  # varint
        _, pos = _read_varint(buf, pos)
        return pos
    if wire == 1:  # fixed64
        return pos + 8
    if wire == 2:  # length-delimited
        length, pos = _read_varint(buf, pos)
        return pos + length
    if wire == 5:  # fixed32
        return pos + 4
    raise ValueError(f"unsupported wire type {wire}")


def _length_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _write_varint(len(payload)) + payload


# ------------------------------ Example codec ------------------------------

FeatureValue = Union[List[bytes], np.ndarray]


def parse_example(data: bytes) -> Dict[str, FeatureValue]:
    """Parses a serialized tf.train.Example into {name: value} where value is
    a list of bytes (BytesList), float32 array (FloatList) or int64 array
    (Int64List)."""
    features: Dict[str, FeatureValue] = {}
    pos = 0
    end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # Example.features
            length, pos = _read_varint(data, pos)
            _parse_features(data[pos:pos + length], features)
            pos += length
        else:
            pos = _skip_field(data, pos, wire)
    return features


def _parse_features(data: bytes, out: Dict[str, FeatureValue]):
    pos = 0
    end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # map entry
            length, pos = _read_varint(data, pos)
            _parse_map_entry(data[pos:pos + length], out)
            pos += length
        else:
            pos = _skip_field(data, pos, wire)


def _parse_map_entry(data: bytes, out: Dict[str, FeatureValue]):
    pos = 0
    end = len(data)
    key = None
    value = None
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            length, pos = _read_varint(data, pos)
            key = data[pos:pos + length].decode("utf-8")
            pos += length
        elif field == 2 and wire == 2:
            length, pos = _read_varint(data, pos)
            value = _parse_feature(data[pos:pos + length])
            pos += length
        else:
            pos = _skip_field(data, pos, wire)
    if key is not None:
        out[key] = value


def _parse_feature(data: bytes) -> FeatureValue:
    pos = 0
    end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        length, pos = _read_varint(data, pos)
        payload = data[pos:pos + length]
        pos += length
        if field == 1:  # BytesList
            return _parse_bytes_list(payload)
        elif field == 2:  # FloatList
            return _parse_float_list(payload)
        elif field == 3:  # Int64List
            return _parse_int64_list(payload)
    return []


def _parse_bytes_list(data: bytes) -> List[bytes]:
    values = []
    pos = 0
    end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        length, pos = _read_varint(data, pos)
        values.append(data[pos:pos + length])
        pos += length
    return values


def _parse_float_list(data: bytes) -> np.ndarray:
    values = []
    pos = 0
    end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:  # packed
            length, pos = _read_varint(data, pos)
            values.append(np.frombuffer(data, np.float32, length // 4, pos))
            pos += length
        elif wire == 5:  # single fixed32
            values.append(np.frombuffer(data, np.float32, 1, pos))
            pos += 4
    if not values:
        return np.zeros((0,), np.float32)
    return np.concatenate(values)


def _parse_int64_list(data: bytes) -> np.ndarray:
    values = []
    pos = 0
    end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:  # packed varints
            length, pos = _read_varint(data, pos)
            sub_end = pos + length
            while pos < sub_end:
                v, pos = _read_varint(data, pos)
                values.append(v - (1 << 64) if v >= (1 << 63) else v)
        elif wire == 0:
            v, pos = _read_varint(data, pos)
            values.append(v - (1 << 64) if v >= (1 << 63) else v)
    return np.asarray(values, dtype=np.int64)


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serializes {name: value} into a tf.train.Example."""
    entries = b""
    for key, value in features.items():
        if isinstance(value, np.ndarray) and value.dtype.kind == "f":
            payload = value.astype("<f4").tobytes()
            flist = _length_delimited(1, payload)
            feature = _length_delimited(2, flist)
        elif isinstance(value, np.ndarray) and value.dtype.kind in ("i", "u", "b"):
            packed = b"".join(
                _write_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                for v in value.reshape(-1)
            )
            ilist = _length_delimited(1, packed)
            feature = _length_delimited(3, ilist)
        else:  # list of bytes
            if isinstance(value, (bytes, str)):
                value = [value]
            items = b"".join(
                _length_delimited(
                    1, v.encode("utf-8") if isinstance(v, str) else bytes(v)
                )
                for v in value
            )
            feature = _length_delimited(1, items)  # Feature.bytes_list
        entry = _length_delimited(1, key.encode("utf-8")) + _length_delimited(
            2, feature
        )
        entries += _length_delimited(1, entry)
    features_msg = entries
    return _length_delimited(1, features_msg)
