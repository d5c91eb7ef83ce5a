"""Mean ms a batch's trunk and FPN takes: the span between the program's
CUDA-event marks that end at "trunk+fpn", over the traced window."""


def read(ctx):
    return ctx["marks"].get("trunk+fpn")
