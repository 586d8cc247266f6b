"""The master's parts that run in one process: the task dispatcher."""
