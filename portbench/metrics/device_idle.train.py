"""The card's idle share of the traced window of training steps: one
less the union of every device operation's interval over the window."""

from portbench.trace import idle_percent


def read(r):
    return idle_percent(r.trace)
