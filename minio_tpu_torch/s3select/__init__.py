from .select import S3SelectError, run_select

__all__ = ["run_select", "S3SelectError"]
