from .region import Region
