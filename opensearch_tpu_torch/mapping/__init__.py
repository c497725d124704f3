from opensearch_tpu_torch.mapping.mapper import DocumentMapper, ParsedDocument  # noqa: F401
from opensearch_tpu_torch.mapping.types import FieldType, build_field_type  # noqa: F401
