from .metric_utils import FeatureStats, MetricOptions
from .metric_main import calc_metric, is_valid_metric, list_valid_metrics
