"""Run loggers (port of ``sheeprl_tpu/utils/logger.py``): ``TensorBoardLogger``,
``MlflowLogger``, ``NoOpLogger``, ``get_logger``, ``run_base_dir`` and
``get_log_dir``, on one process.

The port has no ``tensorboard`` package, so ``TensorBoardLogger`` writes the
event files itself: TFRecord framing (the length, the masked CRC32C of the
length, the data, the masked CRC32C of the data) around ``Event`` protocol
buffers encoded here, the first holding ``file_version "brain.Event:2"``,
then one ``Event{wall_time, step, summary{value{tag, simple_value}}}`` a
scalar. TensorBoard, and :func:`read_scalars`, read them back.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import socket
import struct
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

# -- CRC32C and the TFRecord framing -----------------------------------------


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tf_record(data: bytes) -> bytes:
    length = struct.pack("<Q", len(data))
    return length + struct.pack("<I", masked_crc32c(length)) + data + struct.pack("<I", masked_crc32c(data))


def read_records(path: str) -> Iterator[bytes]:
    """The records of a TFRecord file; a bad checksum raises."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if struct.unpack("<I", header[8:])[0] != masked_crc32c(header[:8]):
                raise ValueError(f"{path}: bad length checksum")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4 or struct.unpack("<I", footer)[0] != masked_crc32c(data):
                raise ValueError(f"{path}: torn or corrupt record")
            yield data


# -- protocol buffer encoding (the fields of event.proto and summary.proto) --


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, wire: int) -> bytes:
    return _varint((number << 3) | wire)


def _bytes_field(number: int, payload: bytes) -> bytes:
    return _field(number, 2) + _varint(len(payload)) + payload


def encode_event(wall_time: float, step: int, file_version: Optional[str] = None, values: bytes = b"") -> bytes:
    """``Event{wall_time = 1, step = 2, file_version = 3, summary = 5}``."""
    out = _field(1, 1) + struct.pack("<d", wall_time) + _field(2, 0) + _varint(int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if values:
        out += _bytes_field(5, values)
    return out


def scalar_value(tag: str, value: float) -> bytes:
    """``Summary.value{tag = 1, simple_value = 2}`` as a float32."""
    return _bytes_field(1, _bytes_field(1, tag.encode()) + _field(2, 5) + struct.pack("<f", float(value)))


def text_value(tag: str, text: str) -> bytes:
    """``Summary.value{tag = 1, metadata = 9 {plugin_data{plugin_name
    "text"}}, tensor = 8 {dtype DT_STRING, shape [1], string_val}}``, as
    ``SummaryWriter.add_text`` writes it."""
    metadata = _bytes_field(1, _bytes_field(1, b"text"))
    shape = _bytes_field(2, _bytes_field(2, _field(1, 0) + _varint(1)))
    tensor = _field(1, 0) + _varint(7) + shape + _bytes_field(8, text.encode())
    return _bytes_field(1, _bytes_field(1, tag.encode()) + _bytes_field(9, metadata) + _bytes_field(8, tensor))


def _decode(data: bytes) -> Iterator[Tuple[int, int, Any]]:
    """``(field, wire type, value)`` for each field of one message."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 1:
            value, pos = data[pos : pos + 8], pos + 8
        elif wire == 5:
            value, pos = data[pos : pos + 4], pos + 4
        elif wire == 2:
            length, pos = _read_varint(data, pos)
            value, pos = data[pos : pos + length], pos + length
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield number, wire, value


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return result, pos


def read_scalars(path: str) -> List[Tuple[int, str, float]]:
    """``(step, tag, value)`` of every scalar in an event file, in order."""
    out: List[Tuple[int, str, float]] = []
    for record in read_records(path):
        step = 0
        summary = b""
        for number, _, value in _decode(record):
            if number == 2:
                step = value
            elif number == 5:
                summary = value
        for number, _, value in _decode(summary):
            if number != 1:
                continue
            tag, simple = None, None
            for vnum, _, v in _decode(value):
                if vnum == 1:
                    tag = v.decode()
                elif vnum == 2:
                    simple = struct.unpack("<f", v)[0]
            if tag is not None and simple is not None:
                out.append((step, tag, simple))
    return out


# -- loggers ------------------------------------------------------------------


class TensorBoardLogger:
    """The lightning logger API the algorithms use (``log_metrics``,
    ``log_hyperparams``, ``finalize``) over an event file of its own in
    ``log_dir``."""

    _files = 0

    def __init__(self, log_dir: str) -> None:
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        TensorBoardLogger._files += 1
        name = f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}.{os.getpid()}.{TensorBoardLogger._files}"
        self.path = os.path.join(log_dir, name)
        self._fh = open(self.path, "wb")
        self._write(encode_event(time.time(), 0, file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._fh.write(tf_record(event))

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        now = time.time()
        for k, v in metrics.items():
            self._write(encode_event(now, step, values=scalar_value(k, float(v))))
        self._fh.flush()

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        text = json.dumps(dict(params), indent=2, default=str)
        self._write(encode_event(time.time(), 0, values=text_value("hparams/text_summary", f"```\n{text}\n```")))
        self._fh.flush()

    def finalize(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


class MlflowLogger:
    """The same surface over MLflow. The port's machines have no ``mlflow``:
    building one without it raises ``ModuleNotFoundError``."""

    def __init__(
        self,
        tracking_uri: Optional[str] = None,
        experiment_name: str = "sheeprl_tpu",
        run_name: Optional[str] = None,
        tags: Optional[Dict[str, Any]] = None,
        log_dir: Optional[str] = None,
    ) -> None:
        if importlib.util.find_spec("mlflow") is None:
            raise ModuleNotFoundError("logger.name=mlflow requires the 'mlflow' package (pip install mlflow)")
        import mlflow

        self._mlflow = mlflow
        self.log_dir = log_dir
        tracking_uri = tracking_uri or os.environ.get("MLFLOW_TRACKING_URI")
        if tracking_uri:
            mlflow.set_tracking_uri(tracking_uri)
        mlflow.set_experiment(experiment_name)
        self.run_id = mlflow.start_run(run_name=run_name, tags=tags).info.run_id

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        clean = {k: float(v) for k, v in metrics.items() if math.isfinite(v)}
        if clean:
            self._mlflow.log_metrics(clean, step=step)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        def flatten(d: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
            out: Dict[str, Any] = {}
            for k, v in d.items():
                out.update(flatten(v, f"{prefix}{k}.") if isinstance(v, Mapping) else {f"{prefix}{k}": v})
            return out

        items = list(flatten(dict(params)).items())
        for i in range(0, len(items), 100):
            self._mlflow.log_params(dict(items[i : i + 100]))

    def finalize(self) -> None:
        self._mlflow.end_run()


class NoOpLogger:
    """Used when logging is off (``metric.log_level`` 0)."""

    log_dir: Optional[str] = None

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        pass

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        pass

    def finalize(self) -> None:
        pass


def run_base_dir(cfg: Mapping[str, Any]) -> str:
    """``<log_base_dir>/<root_dir>/<run_name>``: the parent of the run's
    ``version_N`` directories, where ``telemetry.jsonl`` lands."""
    return os.path.join(cfg.get("log_base_dir") or os.path.join("logs", "runs"), cfg["root_dir"], cfg["run_name"])


def get_log_dir(cfg: Mapping[str, Any]) -> str:
    """A new ``<run base>/version_N`` directory, created."""
    base = run_base_dir(cfg)
    version = 0
    while os.path.isdir(os.path.join(base, f"version_{version}")):
        version += 1
    log_dir = os.path.join(base, f"version_{version}")
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def get_logger(cfg: Mapping[str, Any], log_dir: str):
    """The run's logger: a ``NoOpLogger`` at ``metric.log_level`` 0, else
    the one ``logger.name`` names."""
    if int((cfg.get("metric") or {}).get("log_level", 1)) <= 0:
        return NoOpLogger()
    logger_cfg = cfg.get("logger") or {}
    kind = str(logger_cfg.get("name", "tensorboard")).lower()
    if kind == "tensorboard":
        return TensorBoardLogger(log_dir)
    if kind == "mlflow":
        return MlflowLogger(
            tracking_uri=logger_cfg.get("tracking_uri"),
            experiment_name=str(logger_cfg.get("experiment_name", cfg.get("exp_name", "sheeprl_tpu"))),
            run_name=logger_cfg.get("mlflow_run_name") or cfg.get("run_name"),
            tags=logger_cfg.get("tags"),
            log_dir=log_dir,
        )
    raise ValueError(f"unknown logger {kind!r}; available: ['tensorboard', 'mlflow']")
