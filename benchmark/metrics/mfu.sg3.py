"""The whole unit's share of the card's float32 peak: the operations the
reference counts a unit (``kinds/image_synth.py``: the table's, with the
FIR counted by its real taps) times the traced run's units a second."""
from benchmark.readers import mfu as read  # noqa: F401
