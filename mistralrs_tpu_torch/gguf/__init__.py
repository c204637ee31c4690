from .constants import GGMLType, GGUFValueType, row_byte_size, type_traits
from .planar import PLANAR_TYPES, PlanarQuant, to_planar
from .reader import GGUFContent, GGUFFile, TensorInfo

__all__ = [
    "GGMLType", "GGUFValueType", "row_byte_size", "type_traits",
    "PLANAR_TYPES", "PlanarQuant", "to_planar",
    "GGUFContent", "GGUFFile", "TensorInfo",
]
