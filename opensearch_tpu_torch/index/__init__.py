from opensearch_tpu_torch.index.segment import Segment, SegmentWriter  # noqa: F401
