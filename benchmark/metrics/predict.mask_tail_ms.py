"""Mean ms a batch's mask tail (cleanup, paste, overlap claim, filter, bit-pack) takes: the span between the program's
CUDA-event marks that end at "mask tail", over the traced window."""


def read(ctx):
    return ctx["marks"].get("mask tail")
