"""The plain reference beside channel_own_reference.json, for the
dispatch tests: the channel reference (benchmark_torch/reference.py)
under another path, counting the steppers it makes so that a test can
tell it judged."""
from benchmark_torch import reference as channel

FIELDS = channel.FIELDS
gaps = channel.gaps
plain_setup = channel.plain_setup
made = 0


class Stepper(channel.Stepper):
    def __init__(self, *args, **kwargs):
        global made
        super().__init__(*args, **kwargs)
        made += 1
