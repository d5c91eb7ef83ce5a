"""Mean ms a training step's optimizer (the SGD chain and the working-copy refresh) takes: the span between the program's
CUDA-event marks that end at "optimizer", over the traced window."""


def read(ctx):
    return ctx["marks"].get("optimizer")
