from opensearch_tpu_torch.analysis.registry import AnalysisRegistry, Analyzer, Token  # noqa: F401
