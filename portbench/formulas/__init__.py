"""The yardstick's frozen counts: kernels' work (:mod:`.work`), each model
family's FLOPs per image (``<family>.py``, found by the configuration's
``family``) and the cards' published peaks (:mod:`.peaks`)."""
