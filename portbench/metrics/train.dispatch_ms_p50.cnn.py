"""``train.dispatch_ms_p50.cnn``: ``train.dispatch_ms_p50`` read in the CNN
cells, where it moves ``train_img_s.cnn``."""

from portbench.cell import metric_reader

read = metric_reader("train.dispatch_ms_p50")
