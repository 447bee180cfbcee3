"""setup_s: process start to the first timed day (import, the program's
native libraries loaded or built, the model on the card, boot, perturbation,
the warm-up day and the capture), host clock."""


def read(run, name):
    return run.setup_s
