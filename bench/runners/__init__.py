"""One runner per kind of deployment: ``deploy`` (an iterative app under
``EasyCrashManager``)."""
