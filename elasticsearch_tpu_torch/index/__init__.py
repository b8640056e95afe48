from elasticsearch_tpu_torch.index.segment import Segment, SegmentBuilder, TextFieldColumn
from elasticsearch_tpu_torch.index.translog import Translog
from elasticsearch_tpu_torch.index.engine import Engine

__all__ = ["Segment", "SegmentBuilder", "TextFieldColumn", "Translog", "Engine"]
