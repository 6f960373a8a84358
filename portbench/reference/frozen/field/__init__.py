from . import babybear
from .babybear import P as BABYBEAR_P, add, mul, sub
