"""The port's built-in model zoo: ``model_def`` names resolve here when
no ``model_zoo`` directory is given."""
