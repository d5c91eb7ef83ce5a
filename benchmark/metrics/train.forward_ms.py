"""Mean ms a training step's forward (augmentation, trunk, RPN, matching, heads, losses) takes: the span between the program's
CUDA-event marks that end at "forward", over the traced window."""


def read(ctx):
    return ctx["marks"].get("forward")
