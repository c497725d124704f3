from opensearch_tpu_torch.search.query_dsl import parse_query  # noqa: F401
