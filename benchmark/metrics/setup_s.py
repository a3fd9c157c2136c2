"""Process start to the first timed unit: imports, the K1 build where
it is not cached, the weights made on the card, the warm-up."""


def read(run):
    return run["setup_s"]
