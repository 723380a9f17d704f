"""``k1_roofline.cnn``: ``k1_roofline`` read in the CNN
cells, where it moves ``train_img_s.cnn``."""

from portbench.cell import metric_reader

read = metric_reader("k1_roofline")
