"""The yardstick's counts: the card's published peaks, and the bytes and
floating-point operations that the algorithms of a cell need, worked out
from the configuration's shapes and the RRTMG data files alone."""
