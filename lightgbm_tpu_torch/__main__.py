"""`python -m lightgbm_tpu_torch`: the CLI entry (reference src/main.cpp)."""
from .application import main

main()
