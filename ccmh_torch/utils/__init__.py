from ccmh_torch.utils.logger import MetricsWriter, get_logger

__all__ = ["get_logger", "MetricsWriter"]
