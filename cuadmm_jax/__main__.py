from cuadmm_jax.cli import main
import sys

sys.exit(main())
