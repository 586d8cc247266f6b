"""Telemetry vocabulary shared by the port's layers."""
