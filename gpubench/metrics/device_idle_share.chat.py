"""Device layer, chat cells: the share of the traced slice in which no
operation ran on the card, the harness's waits for an arrival with no
request in the engine left out."""
from gpubench import reduce


def read(rec):
    return reduce.idle_share(rec)
