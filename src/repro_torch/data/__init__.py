"""Data pipeline: deterministic token streams for LM training and the
synthetic IoT sensor sources the paper's dataflows consume (port of
``repro/data``: numpy only, copied as it stands, so both packages give the
same batches)."""
from .tokens import TokenStream, make_lm_batch_iter
from .sensors import SensorStream, SENSOR_TYPES

__all__ = ["TokenStream", "make_lm_batch_iter", "SensorStream", "SENSOR_TYPES"]
