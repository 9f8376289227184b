"""SQOA/QOI format specification constants and header (de)serialization.

This module is the single source of truth for the wire format, transcribed
from the reference format documentation (reference: seqoia.h:65-282) and the
constants block (reference: seqoia.h:398-439). Everything else in
seqoia_tpu_torch builds on these definitions; nothing here touches torch.
The port keeps its own copy so that it imports nothing of the JAX package.

Format summary
--------------
A `.sqoa` file is::

    14-byte header | start byte 0x31 | chunks... | 8-byte end marker

and a `.qoi`-compatible file is the same without the start byte and with the
``qoif`` magic. The header (all integers big-endian, reference seqoia.h:70-77)::

    magic[4]   b"Sqoa" or b"qoif"
    width      u32 BE
    height     u32 BE
    channels   u8   (normalized: 1=MONO, 2=MONOA, 3=RGB, 4=RGBA)
    colorspace u8   (0=sRGB+linear alpha, 1=all linear)

Chunk grammar (reference: seqoia.h:106-280): see the OP_* constants below.
"""

from __future__ import annotations

import dataclasses
import struct

# ---------------------------------------------------------------------------
# Channel / colorspace constants (reference: seqoia.h:309-316)
# ---------------------------------------------------------------------------
CHAN_MONO = 1
CHAN_MONOA = 2
CHAN_RGB = 3
CHAN_RGBA = 4
CHAN_BGR = 5
CHAN_BGRA = 6

SRGB = 0
LINEAR = 1

# ---------------------------------------------------------------------------
# Opcode tags (reference: seqoia.h:398-409)
# ---------------------------------------------------------------------------
OP_REF = 0x00      # 0xxxxxxx  (SQOA only; tags 0x00-0x5f)
OP_ALPHA = 0x60    # 011xxxxx  (SQOA only)
OP_LUMA = 0x80     # 10xxxxxx
OP_RUN = 0xC0      # 11xxxxxx
OP_BIGRUN = 0xFD   # 11111101  (SQOA; in QOI mode this byte is RUN|61)
OP_RGB = 0xFE      # 11111110
OP_RGBA = 0xFF     # 11111111
QOI_OP_INDEX = 0x00  # 00xxxxxx (QOI compat only)
QOI_OP_DIFF = 0x40   # 01xxxxxx (QOI compat only)

MASK_2 = 0xC0

# Run-length limits (reference: seqoia.h:411-413)
SQOA_MAXRUN = 512
QOI_MAXRUN = 62
QOI_INDEX_SIZE = 64
# Mono sources widen the decoder's index to 128 slots (reference: seqoia.h:690-693)
QOI_INDEX_SIZE_MONO = 128

# ---------------------------------------------------------------------------
# File framing (reference: seqoia.h:419-432,439)
# ---------------------------------------------------------------------------
SQOA_MAGIC = b"Sqoa"
QOI_MAGIC = b"qoif"
HEADER_SIZE = 14
START_BYTE = 0x31  # ASCII '1'
PADDING = bytes((0, 0, 0, 0, 0, 0, 0, 1))
PADDING_SIZE = 8
PIXELS_MAX = 400_000_000

# Largest number of stream bytes a single pixel can be responsible for:
# worst-case run flush of a pending run of 511 px = 8x RUN|60 + 1 final RUN
# byte, plus a 5-byte RGBA op and a trailing ALPHA byte never co-occur, but we
# budget generously for the fixed-width emission matrices.
MAX_BYTES_PER_PIXEL = 16


def color_hash(r: int, g: int, b: int, a: int) -> int:
    """QOI color-index hash (reference: seqoia.h:414-417)."""
    return (r * 3 + g * 5 + b * 7 + a * 11) % QOI_INDEX_SIZE


@dataclasses.dataclass
class SqoaDesc:
    """Image description, mirroring the reference's ``sqoa_desc``
    (reference: seqoia.h:318-324). Field names kept identical for API parity.
    """

    width: int = 0
    height: int = 0
    channels: int = 0
    colorspace: int = SRGB
    qoi_compat: int = 0

    # -- derived properties -------------------------------------------------
    @property
    def has_alpha(self) -> bool:
        """Even channel counts carry alpha (reference: seqoia.h:476)."""
        return (self.channels & 1) == 0

    @property
    def col_channels(self) -> int:
        """1 for mono-family inputs, 3 otherwise (reference: seqoia.h:477-485)."""
        return 1 if self.channels < 3 else 3

    @property
    def norm_channels(self) -> int:
        """Channel count as stored in the header: BGR(A) inputs normalize to
        RGB(A) counts (reference: seqoia.h:486)."""
        return self.col_channels + (1 if self.has_alpha else 0)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


def validate_encode_desc(desc: SqoaDesc) -> bool:
    """Encoder-side argument validation (reference: seqoia.h:465-480)."""
    if desc.width == 0 or desc.height == 0:
        return False
    if desc.channels < 1 or desc.channels > 6:
        return False
    if desc.colorspace > 1 or desc.colorspace < 0:
        return False
    if desc.height >= PIXELS_MAX // desc.width:
        return False
    if desc.channels < 3 and desc.qoi_compat:
        return False
    return True


def pack_header(desc: SqoaDesc) -> bytes:
    """Serialize the 14-byte header (+ start byte when not QOI-compatible)
    (reference: seqoia.h:497-514)."""
    magic = QOI_MAGIC if desc.qoi_compat else SQOA_MAGIC
    out = magic + struct.pack(
        ">IIBB", desc.width, desc.height, desc.norm_channels, desc.colorspace
    )
    if not desc.qoi_compat:
        out += bytes((START_BYTE,))
    return out


def unpack_header(data: bytes) -> SqoaDesc | None:
    """Parse and validate a header, returning None on any malformed field
    (reference: seqoia.h:663-707). QOI compatibility is detected by the
    absence of the start byte at offset 14; a ``qoif`` magic that *does*
    carry a start byte is rejected."""
    if len(data) < HEADER_SIZE + PADDING_SIZE:
        return None
    magic = data[0:4]
    width, height = struct.unpack(">II", data[4:12])
    channels = data[12]
    colorspace = data[13]
    qoi_compat = 1 if data[14] != START_BYTE else 0
    if width == 0 or height == 0:
        return None
    if channels < 1 or channels > 6:
        return None
    if colorspace > 1:
        return None
    if magic not in (SQOA_MAGIC, QOI_MAGIC):
        return None
    if magic == QOI_MAGIC and not qoi_compat:
        return None
    if height >= PIXELS_MAX // width:
        return None
    return SqoaDesc(
        width=width,
        height=height,
        channels=channels,
        colorspace=colorspace,
        qoi_compat=qoi_compat,
    )


def worst_case_size(desc: SqoaDesc) -> int:
    """Worst-case encoded size used for buffer sizing.

    One byte larger than the reference's own formula (seqoia.h:487-489):
    that formula forgets the SQOA start byte, making it 1 byte short when
    every pixel emits norm_channels+1 bytes (a latent heap overflow in the
    reference; we size correctly while staying byte-exact on output)."""
    return (
        desc.width * desc.height * (desc.norm_channels + 1)
        + HEADER_SIZE
        + PADDING_SIZE
        + 1
    )


def cap_bucket(x: int) -> int:
    """Round a byte cap up to the next {1, 1.25, 1.5, 1.75}*2^k multiple of
    2048. Adaptive output caps stay within ~25% of their target while the
    number of distinct cap values — each a separate jit specialization of
    the encode kernels — stays bounded."""
    x = max(int(x), 2048)
    k = max((x - 1).bit_length() - 2, 11)
    step = 1 << k
    return -(-x // step) * step
