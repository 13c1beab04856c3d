"""Experiments of the port: `stage3_fleet`, the stage-3 scene fleet."""
