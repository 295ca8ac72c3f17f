"""Host syncs a batch: the program's ``sync.*`` spans in the profiled
stretch, over its units (``host_syncs.reenact``)."""
from benchmark import harness


def read(rec):
    return harness.reader('host_syncs.reenact').syncs_a_unit(rec)
