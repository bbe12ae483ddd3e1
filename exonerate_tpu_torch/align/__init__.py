from .alignment import Alignment, AlignmentArgs
