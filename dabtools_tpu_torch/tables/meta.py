"""Display-name tables from TS 101 756 (registered tables).

Reference counterpart: none — upstream dabtools prints raw ids only.
[K-med — reconstructed from the public registered-tables standard;
wrong names are cosmetic (ids are always shown too).]
"""

from __future__ import annotations

# TS 101 756 table 9 (European languages; the 0x40+ world-language half
# is omitted — unknown codes fall back to hex via `language_name`).
LANGUAGES = {
    0x00: "unknown", 0x01: "Albanian", 0x02: "Breton", 0x03: "Catalan",
    0x04: "Croatian", 0x05: "Welsh", 0x06: "Czech", 0x07: "Danish",
    0x08: "German", 0x09: "English", 0x0A: "Spanish", 0x0B: "Esperanto",
    0x0C: "Estonian", 0x0D: "Basque", 0x0E: "Faroese", 0x0F: "French",
    0x10: "Frisian", 0x11: "Irish", 0x12: "Gaelic", 0x13: "Galician",
    0x14: "Icelandic", 0x15: "Italian", 0x16: "Sami", 0x17: "Latin",
    0x18: "Latvian", 0x19: "Luxembourgian", 0x1A: "Lithuanian",
    0x1B: "Hungarian", 0x1C: "Maltese", 0x1D: "Dutch", 0x1E: "Norwegian",
    0x1F: "Occitan", 0x20: "Polish", 0x21: "Portuguese", 0x22: "Romanian",
    0x23: "Romansh", 0x24: "Serbian", 0x25: "Slovak", 0x26: "Slovene",
    0x27: "Finnish", 0x28: "Swedish", 0x29: "Turkish", 0x2A: "Flemish",
    0x2B: "Walloon",
}

# TS 101 756 table 12 (programme type international codes).
PROGRAMME_TYPES = {
    0: "None", 1: "News", 2: "Current Affairs", 3: "Information",
    4: "Sport", 5: "Education", 6: "Drama", 7: "Culture", 8: "Science",
    9: "Varied", 10: "Pop Music", 11: "Rock Music", 12: "Easy Listening",
    13: "Light Classical", 14: "Serious Classical", 15: "Other Music",
    16: "Weather", 17: "Finance", 18: "Children's", 19: "Social Affairs",
    20: "Religion", 21: "Phone In", 22: "Travel", 23: "Leisure",
    24: "Jazz Music", 25: "Country Music", 26: "National Music",
    27: "Oldies Music", 28: "Folk Music", 29: "Documentary",
}


# TS 102 980 annex A (DL Plus content types; common subset).
DL_PLUS_CONTENT_TYPES = {
    0: "DUMMY", 1: "ITEM.TITLE", 2: "ITEM.ALBUM", 3: "ITEM.TRACKNUMBER",
    4: "ITEM.ARTIST", 5: "ITEM.COMPOSITION", 6: "ITEM.MOVEMENT",
    7: "ITEM.CONDUCTOR", 8: "ITEM.COMPOSER", 9: "ITEM.BAND",
    10: "ITEM.COMMENT", 11: "ITEM.GENRE", 12: "INFO.NEWS",
    13: "INFO.NEWS.LOCAL", 14: "INFO.STOCKMARKET", 15: "INFO.SPORT",
    16: "INFO.LOTTERY", 17: "INFO.HOROSCOPE", 18: "INFO.DAILY_DIVERSION",
    19: "INFO.HEALTH", 20: "INFO.EVENT", 21: "INFO.SCENE",
    22: "INFO.CINEMA", 23: "INFO.TV", 24: "INFO.DATE_TIME",
    25: "INFO.WEATHER", 26: "INFO.TRAFFIC", 27: "INFO.ALARM",
    28: "INFO.ADVERTISEMENT", 29: "INFO.URL", 30: "INFO.OTHER",
    31: "STATIONNAME.SHORT", 32: "STATIONNAME.LONG", 33: "PROGRAMME.NOW",
    34: "PROGRAMME.NEXT", 35: "PROGRAMME.PART", 36: "PROGRAMME.HOST",
    37: "PROGRAMME.EDITORIAL_STAFF", 38: "PROGRAMME.FREQUENCY",
    39: "PROGRAMME.HOMEPAGE", 40: "PROGRAMME.SUBCHANNEL",
    41: "PHONE.HOTLINE", 42: "PHONE.STUDIO", 43: "PHONE.OTHER",
    44: "SMS.STUDIO", 45: "SMS.OTHER", 46: "EMAIL.HOTLINE",
    47: "EMAIL.STUDIO", 48: "EMAIL.OTHER", 49: "MMS.OTHER", 50: "CHAT",
    51: "CHAT.CENTER", 52: "VOTE.QUESTION", 53: "VOTE.CENTRE",
}


def language_name(code: int) -> str:
    return LANGUAGES.get(code, f"lang 0x{code:02X}")


def dlplus_type_name(code: int) -> str:
    return DL_PLUS_CONTENT_TYPES.get(code, f"CT {code}")


def programme_type_name(code: int) -> str:
    return PROGRAMME_TYPES.get(code, f"PTy {code}")
