"""Candidate generators: dict streams, masks, targeted PSK patterns."""

from .dicts import DictStream, md5_file  # noqa: F401
from .mask import mask_keyspace, mask_words  # noqa: F401
from .imei import imei_candidates, luhn_check_digit  # noqa: F401
from .psktool import psk_candidates  # noqa: F401
from .vendors import vendor_candidates  # noqa: F401
