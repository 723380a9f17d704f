"""``train_img_s``: images whose update completed in the window, over the
window's wall time (host clock; the window ends when the last step call
submitted in it has finished)."""


def read(ctx):
    return ctx["images"] / ctx["seconds"]
