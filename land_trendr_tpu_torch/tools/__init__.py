"""tools subpackage: the stage probe and the synthetic pixel population it's
driven with.  Run the probe as ``python -m land_trendr_tpu_torch.tools.probe``."""
