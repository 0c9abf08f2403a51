"""``train.fetch_wait_ms`` in the batch-8 cell, which reports its own rate
(``train_b8_img_per_s``)."""
import harness

read = harness.metric_reader("train.fetch_wait_ms").read
