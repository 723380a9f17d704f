"""``step_mfu.cnn``: ``step_mfu`` read in the CNN
cells, where it moves ``train_img_s.cnn``."""

from portbench.cell import metric_reader

read = metric_reader("step_mfu")
