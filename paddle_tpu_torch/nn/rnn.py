"""Former home of the port's recurrent cells, kept importable: they live at
the reference's path, :mod:`.layer.rnn`."""

from .layer.rnn import GRUCell, LSTMCell, RNNCellBase, SimpleRNNCell  # noqa: F401

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell"]
