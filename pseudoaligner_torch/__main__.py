import os
import sys

from .cli import main

try:
    rc = main()
    # flush here so a closed downstream pipe raises where it can map to
    # the conventional quiet exit
    sys.stdout.flush()
except BrokenPipeError:
    os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    rc = 0
sys.exit(rc)
