"""trainer_build_s: host seconds of the Trainer's constructor (the graph
bundle's normalisation, transposes and segment plans, the model, the
optimizer and the copies to the device)."""


def read(run):
    return run.trainer_build_s
