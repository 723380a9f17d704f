"""``device.idle_share.cnn``: ``device.idle_share`` read in the CNN
cells, where it moves ``train_img_s.cnn``."""

from portbench.cell import metric_reader

read = metric_reader("device.idle_share")
