"""``python -m galaxy_deconv_tpu_torch generate|train|test|bench ...``: the command-line interface."""

from galaxy_deconv_tpu_torch.cli import main

if __name__ == "__main__":
    main()
