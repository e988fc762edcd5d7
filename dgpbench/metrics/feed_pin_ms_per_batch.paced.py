"""``feed_pin_ms_per_batch.infer`` in a cell whose wall-clock rate the
host's producer paces: there that rate is reported per layer
(``infer_frames_per_s.paced``), and this metric names the end-to-end
metric that the cell reports, ``card_ms_per_frame``. The reader is the
one of ``feed_pin_ms_per_batch.infer``."""

from pathlib import Path

from dgpbench import harness

read = harness.load_metric(Path(__file__).resolve().parents[2],
                           "feed_pin_ms_per_batch.infer").read
