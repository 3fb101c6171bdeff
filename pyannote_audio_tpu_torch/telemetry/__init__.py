from .metrics import (is_metrics_enabled, set_telemetry_metrics,
                      telemetry_enabled, track_model_init,
                      track_pipeline_apply, track_pipeline_init)

__all__ = [
    "is_metrics_enabled",
    "set_telemetry_metrics",
    "telemetry_enabled",
    "track_model_init",
    "track_pipeline_apply",
    "track_pipeline_init",
]
