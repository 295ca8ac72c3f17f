"""The whole unit's share of the card's float32 peak: the operations the
reference counts a unit times the traced run's units a second."""
from benchmark.readers import mfu as read  # noqa: F401
