"""``train.graph_share`` in the batch-8 cell, which reports its own rate
(``train_b8_img_per_s``, whose bound its host-bound spread sets)."""
import harness

read = harness.metric_reader("train.graph_share").read
