"""Version info (reference: src/version/version.go:5-24).

``FLAG`` is the pre-release suffix ("-dev", "-rc1", ...). CI enforces that
it is EMPTY on the main branch (the reference's flagtest does the same via
TestFlagEmpty), so tagged releases can never carry a stray dev marker.
"""

MAJOR = 0
MINOR = 1
PATCH = 0
FLAG = ""

__version__ = f"{MAJOR}.{MINOR}.{PATCH}{FLAG}"
