from dynamo_tpu_torch.metrics_exporter.__main__ import MetricsExporter

__all__ = ["MetricsExporter"]
