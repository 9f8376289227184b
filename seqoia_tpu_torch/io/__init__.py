"""File I/O helpers: PNG/JPEG bridges for the converter and bench tools."""

from .png import read_image, write_image

__all__ = ["read_image", "write_image"]
