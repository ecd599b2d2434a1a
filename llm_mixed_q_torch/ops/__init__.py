from . import quantizers
from .quantizers import QUANTIZER_MAP, get_quantizer
