"""TensorBoard-compatible visualization (port of
``bigdl_tpu/visualization``; ref ``spark/visualization/`` +
``utils/Summary.scala``): tfevents writer/reader with masked-CRC32C record
framing and a hand-rolled protobuf codec for the Event schema.  Pure
Python: a port ``FileWriter`` writes the reference's bytes."""
from .crc import crc32c, masked_crc32c
from .proto import Event, HistogramProto, SummaryValue, decode_event
from .record import RecordWriter, read_records
from .reader import list_files, list_tags, read_scalar
from .summary import (ObsSummary, Summary, ServingSummary, TrainSummary,
                      ValidationSummary, histogram, scalar)
from .writer import EventWriter, FileWriter

__all__ = [
    "crc32c", "masked_crc32c", "Event", "HistogramProto", "SummaryValue",
    "decode_event", "RecordWriter", "read_records", "list_files",
    "list_tags", "read_scalar", "Summary", "ObsSummary", "ServingSummary",
    "TrainSummary", "ValidationSummary", "histogram", "scalar",
    "EventWriter", "FileWriter",
]
