"""``train_img_s.cnn``: ``train_img_s`` of the CNN cells, a metric of its
own: their host-paced rate spreads ten times the ViT cells' and takes a
wider bound."""

from portbench.cell import metric_reader

read = metric_reader("train_img_s")
