import sys

from idc_models_tpu_torch.cli import main

sys.exit(main())
