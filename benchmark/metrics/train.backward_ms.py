"""Mean ms a training step's backward takes: the span between the program's
CUDA-event marks that end at "backward", over the traced window."""


def read(ctx):
    return ctx["marks"].get("backward")
